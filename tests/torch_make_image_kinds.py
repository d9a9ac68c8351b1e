"""Writes ``tests/fixtures/image_kinds/``: one small file of every JPEG,
netpbm, TIFF, BMP, PFM, GIF, WebP, QOI, Sun raster, PCX, SGI, TGA, ICO,
CUR, DIB and DDS kind that PIL's
``Image.open(p).convert("L")`` reads (or refuses), one file of each format
PIL reads by a signature that the port does not read yet, the full-width
progressive stereo sequence, and ``manifest.json`` (each file's kind and the sha256 of PIL's
``convert("L")`` pixels; for a refused file the word its refusal names it
by, and ``pil_reads`` where PIL reads what the port refuses).

PIL writes the kinds it can write (progressive, CMYK, RGB, baseline JPEG;
TIFF uncompressed, PackBits, LZW, Deflate and the libtiff compressions,
JPEG and CCITT among them;
BMP 1, L, P, RGB, RGBA; GIF; WebP lossless, lossy, with alpha, animated;
JPEG 2000, ICO, QOI, DDS, SGI, PCX, AVIF). The kinds it cannot write come
from the small encoders in this file:

- sequential and progressive Huffman JPEG with any scan script (including
  scripts that stop short of full refinement), any component count and any
  integral or fractional sampling factors, restart intervals, DNL;
- arithmetic-coded JPEG (SOF9, SOF10; the QM coder of ITU T.81 Annex D);
- lossless JPEG (SOF3, Huffman; predictors 1-7, point transform);
- netpbm P1-P6 at any maxval, PFM in both byte orders;
- TIFF of any bits, photometric and sample format, strips or tiles,
  chunky or planar, either byte order, classic or BigTIFF, fill order 2,
  uncompressed, PackBits, LZW or Deflate, LZMA (the standard library's
  ``lzma``, or Pillow's liblzma through ctypes for the ARM64 and RISC-V
  filters) or ZSTD (Pillow's libzstd through ctypes, or this file's frame
  writer: raw and RLE blocks, raw, RLE, Huffman and treeless literals, RLE
  and repeat sequence tables), predictors 2 and 3; ThunderScan over every
  code; around
  ``encode_jpeg``: new-style JPEG strips and tiles with JPEGTables, and
  old-style JPEG (tables tags or an interchange stream, one restart
  interval a strip); subsampled YCbCr blocks; CCITT Modified Huffman,
  RLEW, Group 3 1D/2D with EOLs and fill bits, and Group 4; PIL's
  Floyd-Steinberg dither of ``convert("1")``;
- BMP of every header size and depth, RLE4 and RLE8 (deltas, early ends),
  BITFIELDS, top-down rows; PSD by hand;
- numpy-only (the card's machine has no PIL): QOI with every op, Sun
  raster raw or RLE at each depth with colour maps, PCX of every mode
  (bit planes, the 256-colour palette), SGI raw or RLE with its tables,
  TGA of types 1-3 and 9-11 (colour maps of 16 or 24 bits from a first
  index, literals and runs across rows, both orientation bits),
  headerless DIBs, ICO and CUR directories of DIB entries with AND masks
  (or PNG entries), DDS headers (FourCC, DX10, bit masks) with BC1 and
  BC7 (mode 6) block encoders;
- GIF with identity palettes (global, local), a local palette over a
  global one, frame 0 past the screen or inside it, LZW code sizes 2-13,
  no End code, early End codes, cut streams, blocks before the image;
- WebP: a numpy-only VP8L writer of gray frames, animations assembled
  from still files with frame 0 at an offset, and libwebp's own encoder
  through ctypes (Pillow's bundled library) for the VP8 options PIL's
  ``save`` does not reach: the simple filter, sharpness, token
  partitions, one segment, raw alpha.

The tests (``tests/test_torch_image_kinds.py``) import this module for
its encoder; it is not collected by pytest. Everything is deterministic
from ``--seed``.

    python tests/torch_make_image_kinds.py [--out DIR] [--seed N]
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "fixtures", "image_kinds")

# natural-order index of each zigzag position
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K.1's example tables (natural order), luminance and chrominance
_Q_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                      24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                     + [99] * 32)


def quant_table(quality: int, chroma: bool = False) -> np.ndarray:
    """libjpeg's quality scaling of the Annex K tables (natural order)."""
    base = _Q_CHROMA if chroma else _Q_LUMA
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix() -> np.ndarray:
    c = np.zeros((8, 8))
    for u in range(8):
        for x in range(8):
            c[u, x] = np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    return c


_C = _dct_matrix()


def block_coefficients(plane: np.ndarray, q: np.ndarray, bw: int, bh: int,
                       level: int = 128) -> np.ndarray:
    """(bh, bw, 64) quantized DCT coefficients (natural order) of ``plane``
    padded to ``bw`` × ``bh`` blocks by repeating its last row and column."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - level, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    f = np.einsum("ux,abxy,vy->abuv", _C, blocks, _C)
    return np.round(f.reshape(bh, bw, 64) / q.reshape(64)).astype(np.int64)


# ------------------------------------------------------------------ Huffman
def optimal_table(freq) -> tuple[list, list]:
    """(BITS[16], HUFFVAL) of a length-limited Huffman code for ``freq``
    (256 counts), as ITU T.81 Annex K.2 builds it (no code of all ones)."""
    freq = [int(f) for f in freq] + [1]
    if sum(freq[:256]) == 0:
        freq[0] = 1
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1, v = -1, None
        for i in range(257):
            if freq[i] and (v is None or freq[i] <= v):
                v, c1 = freq[i], i
        c2, v = -1, None
        for i in range(257):
            if freq[i] and (v is None or freq[i] <= v) and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 40
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(39, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved symbol 256
    vals = [s for n in range(1, 40) for s in range(256) if codesize[s] == n]
    return bits[1:17], vals


def canonical_codes(bits, vals) -> dict:
    """symbol → (code, length)."""
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            codes[vals[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    """Entropy-coded bytes: MSB first, 0xFF followed by a stuffed 0x00,
    padded with one bits at a flush."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)

    def marker(self, code: int):
        self.flush()
        self.out += bytes([0xFF, code])


def bit_length(v: int) -> int:
    return int(v).bit_length()


def magnitude(v: int) -> tuple[int, int]:
    """(category, extra bits) of a signed value (JPEG's EXTEND inverse)."""
    s = bit_length(abs(v))
    return s, (v if v >= 0 else v + (1 << s) - 1) & ((1 << s) - 1)


# ------------------------------------------------------------------- frames
class Component:
    def __init__(self, cid: int, h: int, v: int, tq: int, plane: np.ndarray):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.plane = np.asarray(plane)  # full-resolution samples, subsampled below


class Frame:
    """A JPEG frame: components (with sampling factors), their planes
    subsampled by box averaging, the MCU grid, and per-component blocks.
    ``lossless``: data units are single samples, not 8×8 blocks."""

    def __init__(self, comps, width: int, height: int, lossless: bool = False):
        self.comps, self.W, self.H, self.lossless = comps, width, height, lossless
        self.hmax = max(c.h for c in comps)
        self.vmax = max(c.v for c in comps)
        unit = 1 if lossless else 8
        self.mcux = -(-width // (unit * (self.hmax if len(comps) > 1 else 1)))
        self.mcuy = -(-height // (unit * (self.vmax if len(comps) > 1 else 1)))
        for c in comps:
            h_, v_ = (c.h, c.v) if len(comps) > 1 else (1, 1)
            hm, vm = (self.hmax, self.vmax) if len(comps) > 1 else (1, 1)
            c.dw = -(-width * h_ // hm)
            c.dh = -(-height * v_ // vm)
            c.wb = -(-c.dw // unit)  # width in blocks (own grid)
            c.hb = -(-c.dh // unit)
            c.bw = self.mcux * h_  # allocated (MCU grid)
            c.bh = self.mcuy * v_
            c.sub = _subsample(c.plane, c.dw, c.dh, width, height)


def _subsample(plane, dw, dh, W, H):
    """``plane`` (H, W) averaged down to (dh, dw) boxes (rounded)."""
    plane = np.asarray(plane, np.float64)
    if (dh, dw) == plane.shape:
        return plane
    fy, fx = -(-H // dh), -(-W // dw)
    p = np.pad(plane, ((0, dh * fy - H), (0, dw * fx - W)), mode="edge")
    return np.round(p.reshape(dh, fy, dw, fx).mean((1, 3)))


def mcu_blocks(frame: Frame, comps):
    """The scan's MCUs in order: each a list of (component, row, col)."""
    if len(comps) == 1:
        c = comps[0]
        return [[(c, y, x)] for y in range(c.hb) for x in range(c.wb)]
    out = []
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            out.append([(c, my * c.v + by, mx * c.h + bx) for c in comps
                        for by in range(c.v) for bx in range(c.h)])
    return out


# ------------------------------------------------------ Huffman scan events
# A Huffman scan is written as a list of events: ("s", table, symbol),
# ("b", value, nbits) and ("r",) for a restart; the tables are then built
# from the symbols' counts and the events serialized.

def _dc_events(ev, table, diff):
    s, extra = magnitude(diff)
    ev.append(("s", table, s))
    if s:
        ev.append(("b", extra, s))


def seq_scan_events(frame, comps, coefs, restart: int):
    ev, pred = [], {}
    for i, mcu in enumerate(mcu_blocks(frame, comps)):
        if restart and i and i % restart == 0:
            ev.append(("r",))
            pred = {}
        for c, y, x in mcu:
            blk = coefs[c.id][y, x]
            _dc_events(ev, ("dc", c.td), int(blk[0]) - pred.get(c.id, 0))
            pred[c.id] = int(blk[0])
            zz = blk[ZIGZAG]
            r = 0
            last = max([k for k in range(1, 64) if zz[k]], default=0)
            for k in range(1, last + 1):
                if zz[k] == 0:
                    r += 1
                    continue
                while r > 15:
                    ev.append(("s", ("ac", c.ta), 0xF0))
                    r -= 16
                s, extra = magnitude(int(zz[k]))
                ev.append(("s", ("ac", c.ta), (r << 4) | s))
                ev.append(("b", extra, s))
                r = 0
            if last < 63:
                ev.append(("s", ("ac", c.ta), 0x00))
    return ev


def _ishift(v: int, al: int) -> int:
    return v >> al  # arithmetic shift (floor), as IRIGHT_SHIFT


def prog_scan_events(frame, comps, coefs, ss, se, ah, al, restart: int):
    """One progressive Huffman scan as libjpeg's jcphuff.c codes it."""
    ev = []
    if ss == 0:  # DC scans, interleaved or not
        pred = {}
        for i, mcu in enumerate(mcu_blocks(frame, comps)):
            if restart and i and i % restart == 0:
                ev.append(("r",))
                pred = {}
            for c, y, x in mcu:
                v = int(coefs[c.id][y, x, 0])
                if ah == 0:
                    t = _ishift(v, al)
                    _dc_events(ev, ("dc", c.td), t - pred.get(c.id, 0))
                    pred[c.id] = t
                else:
                    ev.append(("b", (v >> al) & 1, 1))
        return ev
    c = comps[0]
    table = ("ac", c.ta)
    state = {"eobrun": 0, "be": []}  # pending EOB run and its correction bits

    def emit_eobrun():
        if state["eobrun"]:
            n = bit_length(state["eobrun"]) - 1
            ev.append(("s", table, n << 4))
            if n:
                ev.append(("b", state["eobrun"] & ((1 << n) - 1), n))
            state["eobrun"] = 0
        for b in state["be"]:
            ev.append(("b", b, 1))
        state["be"] = []

    for i, mcu in enumerate(mcu_blocks(frame, comps)):
        if restart and i and i % restart == 0:
            emit_eobrun()
            ev.append(("r",))
        (_, y, x), = mcu
        zz = coefs[c.id][y, x][ZIGZAG]
        if ah == 0:  # AC first
            r = 0
            for k in range(ss, se + 1):
                v = int(zz[k])
                t = abs(v) >> al
                if t == 0:
                    r += 1
                    continue
                emit_eobrun()
                while r > 15:
                    ev.append(("s", table, 0xF0))
                    r -= 16
                s = bit_length(t)
                extra = t if v >= 0 else (~t) & ((1 << s) - 1)
                ev.append(("s", table, (r << 4) | s))
                ev.append(("b", extra, s))
                r = 0
            if r > 0:
                state["eobrun"] += 1
                if state["eobrun"] == 0x7FFF:
                    emit_eobrun()
        else:  # AC refinement
            absv = [abs(int(zz[k])) >> al for k in range(64)]
            eob = max([k for k in range(ss, se + 1) if absv[k] == 1], default=0)
            r, br = 0, []
            for k in range(ss, se + 1):
                t = absv[k]
                if t == 0:
                    r += 1
                    continue
                while r > 15 and k <= eob:
                    emit_eobrun()
                    ev.append(("s", table, 0xF0))
                    r -= 16
                    for b in br:
                        ev.append(("b", b, 1))
                    br = []
                if t > 1:
                    br.append(t & 1)
                    continue
                emit_eobrun()
                ev.append(("s", table, (r << 4) | 1))
                ev.append(("b", 1 if int(zz[k]) >= 0 else 0, 1))
                for b in br:
                    ev.append(("b", b, 1))
                br, r = [], 0
            if r > 0 or br:
                state["eobrun"] += 1
                state["be"] += br
                if state["eobrun"] == 0x7FFF or len(state["be"]) > 937:
                    emit_eobrun()
    emit_eobrun()
    return ev


def lossless_scan_events(frame, comps, samples, predictor: int, pt: int, restart: int,
                         precision: int = 8):
    """A lossless Huffman scan: each sample's difference from its predictor
    (ITU T.81 Annex H), rows after a restart predicted as the first row."""
    ev = []
    mcus = mcu_blocks(frame, comps)
    per_row = frame.mcux if len(comps) > 1 else comps[0].wb
    if restart and restart % per_row:
        raise ValueError("a lossless restart interval must hold whole MCU rows")
    # the row of each component at which the last restart happened
    first_rows = {c.id: {0} for c in comps}
    rows_per_mcu_row = {c.id: (c.v if len(comps) > 1 else 1) for c in comps}
    if restart:
        for c in comps:
            step = restart // per_row * rows_per_mcu_row[c.id]
            first_rows[c.id] = set(range(0, c.bh, step))
    init = 1 << (precision - pt - 1)
    shifted = {c.id: samples[c.id] >> pt for c in comps}
    for i, mcu in enumerate(mcus):
        if restart and i and i % restart == 0:
            ev.append(("r",))
        for c, y, x in mcu:
            s = shifted[c.id]
            if y >= c.dh or x >= c.dw:
                diff = 0  # padding of the MCU grid: read and dropped
            else:
                cur = int(s[y, x])
                if y in first_rows[c.id]:
                    pred = init if x == 0 else int(s[y, x - 1])
                elif x == 0:
                    pred = int(s[y - 1, x])
                else:
                    ra, rb, rc = int(s[y, x - 1]), int(s[y - 1, x]), int(s[y - 1, x - 1])
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                diff = (cur - pred) & 0xFFFF
                if diff >= 0x8000:
                    diff -= 0x10000
            if diff == -32768:
                ev.append(("s", ("dc", c.td), 16))
            else:
                _dc_events(ev, ("dc", c.td), diff)
    return ev


def serialize_huffman(ev, tables=None):
    """(DHT segment, entropy-coded bytes with RST markers) of an event list."""
    if tables is None:
        freq = {}
        for e in ev:
            if e[0] == "s":
                freq.setdefault(e[1], np.zeros(256, np.int64))[e[2]] += 1
        tables = {k: optimal_table(f) for k, f in freq.items()}
    codes = {k: canonical_codes(*t) for k, t in tables.items()}
    w, rst = BitWriter(), 0
    for e in ev:
        if e[0] == "s":
            code, n = codes[e[1]][e[2]]
            w.put(code, n)
        elif e[0] == "b":
            w.put(e[1], e[2])
        else:
            w.marker(0xD0 + rst)
            rst = (rst + 1) & 7
    w.flush()
    body = b""
    for (cls, th), (bits, vals) in sorted(tables.items()):
        body += bytes([(0 if cls == "dc" else 1) << 4 | th]) + bytes(bits) + bytes(vals)
    return (segment(0xC4, body) if tables else b""), bytes(w.out)


# --------------------------------------------------------- arithmetic coding
# ITU T.81 Table D.2 as libjpeg's jaricom.c holds it: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); entry 113 is the fixed 0.5 estimate.
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class ArithEncoder:
    """The QM coder's encoder as libjpeg's jcarith.c runs it (Annex D)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b & 0xFF)

    def _flush_pending(self, byte):
        """Output the buffered byte and stacked 0xFFs (no carry)."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            self._emit(self.buffer)
        if self.sc:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            while self.sc:
                self._emit(0xFF)
                self._emit(0)
                self.sc -= 1
        self.buffer = byte

    def _carry(self, byte):
        if self.buffer >= 0:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            self._emit(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self._emit(0)
        self.zc += self.sc
        self.sc = 0
        self.buffer = byte

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe, nl, nm, sw = QE_TABLE[sv & 0x7F]
        nl |= sw << 7
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) + nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry(temp & 0xFF)
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_pending(temp & 0xFF)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_pending(-1)
        if self.c & 0x7FFF800:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            self._emit(self.c >> 19)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit(self.c >> 11)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        self.reset()


FIXED = [113]  # the fixed-probability bin of sign bits and DC refinement


class ArithScan:
    """Statistics of one scan (reset at each restart) and its coding of
    DC differences and AC coefficients (jcarith.c)."""

    def __init__(self, enc, dc_l=0, dc_u=1, ac_k=5):
        self.enc, self.L, self.U, self.K = enc, dc_l, dc_u, ac_k
        self.reset()

    def reset(self):
        self.dc_stats, self.ac_stats, self.ctx, self.last = {}, {}, {}, {}

    def _dc(self, tbl):
        return self.dc_stats.setdefault(tbl, [0] * 64)

    def _ac(self, tbl):
        return self.ac_stats.setdefault(tbl, [0] * 256)

    def dc(self, tbl, cid, value):
        e, st = self.enc, self._dc(tbl)
        s0 = self.ctx.get(cid, 0)
        v = value - self.last.get(cid, 0)
        if v == 0:
            e.encode(st, s0, 0)
            self.ctx[cid] = 0
            return
        self.last[cid] = value
        e.encode(st, s0, 1)
        if v > 0:
            e.encode(st, s0 + 1, 0)
            i = s0 + 2
            self.ctx[cid] = 4
        else:
            v = -v
            e.encode(st, s0 + 1, 1)
            i = s0 + 3
            self.ctx[cid] = 8
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                e.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        e.encode(st, i, 0)
        if m < (1 << self.L) >> 1:
            self.ctx[cid] = 0
        elif m > (1 << self.U) >> 1:
            self.ctx[cid] += 8
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def _magnitude(self, st, i, k, v):
        e = self.enc
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                e.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= self.K else 217
                v2 >>= 1
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        e.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def ac_first(self, tbl, zz, ss, se, al):
        """Sequential (ss=1, se=63, al=0) or progressive first AC scan."""
        e, st = self.enc, self._ac(tbl)
        vals = [(abs(int(zz[k])) >> al) * (1 if zz[k] >= 0 else -1) for k in range(64)]
        ke = 0
        for k in range(se, 0, -1):
            if vals[k]:
                ke = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while vals[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            v = vals[k]
            e.encode(FIXED, 0, 0 if v > 0 else 1)
            self._magnitude(st, i + 2, k, abs(v))
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, zz, ss, se, ah, al):
        e, st = self.enc, self._ac(tbl)
        absal = [abs(int(zz[k])) >> al for k in range(64)]
        absah = [abs(int(zz[k])) >> ah for k in range(64)]
        ke = 0
        for k in range(se, 0, -1):
            if absal[k]:
                ke = k
                break
        kex = 0
        for k in range(ke, 0, -1):
            if absah[k]:
                kex = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = absal[k]
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(FIXED, 0, 0 if zz[k] >= 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


def arith_scan_bytes(frame, comps, coefs, ss, se, ah, al, restart, progressive, dac=None):
    """The entropy-coded bytes (with RST markers) of one arithmetic scan."""
    enc = ArithEncoder()
    dac = dac or {}
    sc = ArithScan(enc, *dac.get("dc", (0, 1)), dac.get("k", 5))
    out, rst = bytearray(), 0
    for i, mcu in enumerate(mcu_blocks(frame, comps)):
        if restart and i and i % restart == 0:
            enc.finish()
            out += enc.out + bytes([0xFF, 0xD0 + rst])
            enc.out = bytearray()
            rst = (rst + 1) & 7
            sc.reset()
        for c, y, x in mcu:
            blk = coefs[c.id][y, x]
            zz = blk[ZIGZAG]
            if not progressive:
                sc.dc(c.td, c.id, int(blk[0]))
                sc.ac_first(c.ta, zz, 1, 63, 0)
            elif ss == 0 and ah == 0:
                sc.dc(c.td, c.id, _ishift(int(blk[0]), al))
            elif ss == 0:
                enc.encode(FIXED, 0, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                sc.ac_first(c.ta, zz, ss, se, al)
            else:
                sc.ac_refine(c.ta, zz, ss, se, ah, al)
    enc.finish()
    return bytes(out + enc.out)


# ---------------------------------------------------------------- the file
def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def dqt(tables: dict) -> bytes:
    body = b""
    for t, q in sorted(tables.items()):
        q = np.asarray(q)[ZIGZAG]
        if q.max() > 255:
            body += bytes([0x10 | t]) + b"".join(struct.pack(">H", int(v)) for v in q)
        else:
            body += bytes([t]) + bytes(int(v) for v in q)
    return segment(0xDB, body)


def sof(marker: int, precision: int, width: int, height: int, comps) -> bytes:
    body = struct.pack(">BHHB", precision, height, width, len(comps))
    for c in comps:
        body += bytes([c.id, (c.h << 4) | c.v, c.tq])
    return segment(marker, body)


def sos(comps, ss, se, ah, al) -> bytes:
    body = bytes([len(comps)])
    for c in comps:
        body += bytes([c.id, (c.td << 4) | c.ta])
    return segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def encode_jpeg(planes, sampling=None, ids=None, quality: int = 75, qtables=None,
                mode: str = "sequential", arith: bool = False, scans=None,
                restart: int = 0, markers: bytes = JFIF, predictor: int = 1, pt: int = 0,
                precision: int = 8, sof_marker: int | None = None, dnl: bool = False,
                dac=None, prefix: bytes = b"", huffman=None) -> bytes:
    """A JPEG of ``planes`` (full-resolution (H, W) arrays, one per
    component; subsampled by ``sampling`` [(h, v), ...] box averages).

    ``mode``: "sequential", "progressive" (``scans``: [(component indices,
    Ss, Se, Ah, Al), ...]) or "lossless" (``predictor``, ``pt``, or per
    scan in ``scans`` as (component indices, predictor, 0, 0, pt));
    ``arith``: arithmetic coding (``dac``: {"dc": (L, U), "k": K} writes a
    DAC marker); ``restart``: MCUs per restart interval; ``markers``: the
    APPn segments after SOI; ``sof_marker`` overrides the SOF code;
    ``dnl``: height 0 in the frame header and a DNL marker after the first
    scan; ``prefix``: segments written before the frame (DHP);
    ``huffman``: the Huffman tables {("dc" | "ac", id): (bits, vals)} every
    scan codes with (default: each scan's optimal ones)."""
    planes = [np.asarray(p) for p in planes]
    H, W = planes[0].shape
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    comps = [Component(ids[i], sampling[i][0], sampling[i][1],
                       0 if i == 0 or n == 4 else 1, planes[i]) for i in range(n)]
    for i, c in enumerate(comps):
        c.td = c.ta = 0 if (i == 0 or n == 4) else 1
    lossless = mode == "lossless"
    frame = Frame(comps, W, H, lossless)
    if qtables is None:
        qtables = {0: quant_table(quality)}
        if n == 3:
            qtables[1] = quant_table(quality, chroma=True)
    coefs, samples = {}, {}
    for c in comps:
        if lossless:
            s = np.clip(np.round(c.sub), 0, (1 << precision) - 1).astype(np.int64)
            samples[c.id] = np.pad(s, ((0, c.bh - c.dh), (0, c.bw - c.dw)), mode="edge")
        else:
            coefs[c.id] = block_coefficients(c.sub, qtables[c.tq], c.bw, c.bh,
                                             level=1 << (precision - 1))
    if sof_marker is None:
        sof_marker = {("sequential", False): 0xC1 if precision > 8 else 0xC0,
                      ("progressive", False): 0xC2, ("lossless", False): 0xC3,
                      ("sequential", True): 0xC9, ("progressive", True): 0xCA,
                      ("lossless", True): 0xCB}[(mode, arith)]
    out = b"\xff\xd8" + markers + prefix
    if not lossless:
        out += dqt(qtables)
    out += sof(sof_marker, precision, W, 0 if dnl else H, comps)
    if arith and dac:
        body = b""
        for t in sorted({c.td for c in comps}):
            L, U = dac.get("dc", (0, 1))
            body += bytes([t, (U << 4) | L])
        for t in sorted({c.ta for c in comps}):
            body += bytes([0x10 | t, dac.get("k", 5)])
        out += segment(0xCC, body)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    if mode == "sequential":
        scans = [(list(range(n)), 0, 63, 0, 0)]
    elif lossless and scans is None:
        scans = [(list(range(n)), predictor, 0, 0, pt)]
    elif scans is None:
        scans = default_progression(n)
    for k, (idx, ss, se, ah, al) in enumerate(scans):
        sc = [comps[i] for i in idx]
        if lossless:  # (components, predictor, -, -, point transform)
            header = sos(sc, ss, 0, 0, al)
        else:
            header = sos(sc, ss, se, ah, al)
        if arith:
            data = arith_scan_bytes(frame, sc, coefs, ss, se, ah, al, restart,
                                    mode == "progressive", dac)
            out += header + data
        else:
            if lossless:
                ev = lossless_scan_events(frame, sc, samples, ss, al, restart, precision)
            elif mode == "sequential":
                ev = seq_scan_events(frame, sc, coefs, restart)
            else:
                ev = prog_scan_events(frame, sc, coefs, ss, se, ah, al, restart)
            dht, data = serialize_huffman(ev, huffman)
            out += dht + header + data
        if dnl and k == 0:
            out += segment(0xDC, struct.pack(">H", H))
    return out + b"\xff\xd9"


def default_progression(n: int) -> list:
    """libjpeg's jpeg_simple_progression script for 1 or 3 components (and
    the same shape for 4): every coefficient refined to Al = 0."""
    allc = list(range(n))
    if n == 3:
        return [(allc, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), (allc, 0, 0, 1, 0),
                ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
    s = [(allc, 0, 0, 0, 1)]
    for c in allc:
        s += [([c], 1, 5, 0, 2), ([c], 6, 63, 0, 2), ([c], 1, 63, 2, 1)]
    s += [(allc, 0, 0, 1, 0)]
    s += [([c], 1, 63, 1, 0) for c in allc]
    return s


def random_scan_script(rng, n: int, complete: bool = True) -> list:
    """A random progressive script that the spectral-selection and
    successive-approximation rules allow: DC first (interleaved or per
    component), then per component random bands at random Al, refined
    down one bit per scan; ``complete=False`` may stop short of Al = 0 and
    leave bands unsent."""
    scans = []
    dc_al = int(rng.integers(0, 3))
    if n > 1 and rng.random() < 0.5:
        scans.append((list(range(n)), 0, 0, 0, dc_al))
    else:
        scans += [([c], 0, 0, 0, dc_al) for c in range(n)]
    pending = []
    for c in range(n):
        cuts = sorted(set(int(x) for x in rng.integers(2, 63, int(rng.integers(0, 4)))))
        edges = [1] + cuts + [64]
        for lo, hi in zip(edges[:-1], edges[1:]):
            if not complete and rng.random() < 0.2:
                continue
            al = int(rng.integers(0, 4))
            scans.append(([c], lo, hi - 1, 0, al))
            stop = int(rng.integers(0, al + 1)) if not complete else 0
            pending += [([c], lo, hi - 1, a + 1, a) for a in range(al - 1, stop - 1, -1)]
    # the bands' refinement runs in a random order, each run in Ah order
    bands = {}
    for s in pending:
        bands.setdefault((s[0][0], s[1]), []).append(s)
    runs = list(bands.values())
    for i in rng.permutation(len(runs)):
        scans += runs[i]
    dc_stop = 0 if complete else int(rng.integers(0, dc_al + 1))
    for a in range(dc_al - 1, dc_stop - 1, -1):
        scans.append((list(range(n)), 0, 0, a + 1, a))
    return scans


# ------------------------------------------------------------------ netpbm
def encode_pnm(kind: str, img: np.ndarray, maxval: int = 255, comment: bytes = b"",
               line: int = 12) -> bytes:
    """P1-P6 bytes of ``img`` (samples already in 0..maxval; P1/P4 take
    0/1 with 1 black). Plain kinds wrap ``line`` samples per line and put
    ``comment`` lines in the header and the body."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    head = kind.encode() + b"\n" + (b"# " + comment + b"\n" if comment else b"")
    head += b"%d %d\n" % (W, H)
    if kind in ("P1", "P4"):
        if kind == "P4":
            rows = np.packbits(img.astype(np.uint8), axis=1)
            return head + rows.tobytes()
        flat = img.reshape(-1)
        body = b"\n".join(b"".join(b"%d" % v for v in flat[i:i + line])
                          for i in range(0, len(flat), line))
        return head + body + b"\n"
    head += b"%d\n" % maxval
    if kind in ("P5", "P6"):
        dt = ">u2" if maxval > 255 else np.uint8
        return head + np.ascontiguousarray(img, dt).tobytes()
    flat = img.reshape(-1)
    lines = [b" ".join(b"%d" % v for v in flat[i:i + line]) for i in range(0, len(flat), line)]
    if comment:
        lines.insert(len(lines) // 2, b"# " + comment)
    return head + b"\n".join(lines) + b"\n"


# ------------------------------------------------------------------ TIFF
# struct codes of the TIFF types (2, ASCII, is written as bytes; 5 and 10,
# the rationals, as numerator and denominator)
TIFF_TYPES = {1: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i",
              11: "f", 12: "d", 13: "I", 16: "Q", 17: "q"}


def packbits(row: bytes) -> bytes:
    """PackBits (TIFF compression 32773) of one row: runs of 2-128 equal
    bytes as (257 - n, byte), the rest as literals of at most 128."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j + 1 - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and row[j] == row[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW (compression 5): MSB-first codes of 9-12 bits, Clear 256 and
    EOI 257, the width growing as the next free code reaches 512, 1024,
    2048 (the decoder, one entry behind, switches one code early); a Clear
    before the table passes 4093 entries."""
    out = bytearray()
    table, width, nxt = {}, 9, 258
    acc, nacc = 256, 9  # Clear first
    w = -1
    for b in data:
        if w < 0:
            w = b
            continue
        key = (w << 8) | b
        c = table.get(key)
        if c is not None:
            w = c
            continue
        acc = (acc << width) | w
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1
        table[key] = nxt
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
        if nxt >= 4094:
            acc = (acc << width) | 256
            nacc += width
            table, width, nxt = {}, 9, 258
        w = b
    if w >= 0:
        acc = (acc << width) | w
        nacc += width
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
    acc = (acc << width) | 257  # EOI
    nacc += width
    while nacc >= 8:
        nacc -= 8
        out.append((acc >> nacc) & 255)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _pack_samples(block: np.ndarray, bits: int, sf: int, order: str) -> list:
    """(rows, cols, s) samples → one byte string per row."""
    rows = block.reshape(block.shape[0], -1)
    if bits in (1, 2, 4):
        out = []
        for r in rows:
            v = r.astype(np.uint8) & ((1 << bits) - 1)
            per = 8 // bits
            v = np.pad(v, (0, -len(v) % per)).reshape(-1, per)
            shifts = np.arange(per - 1, -1, -1) * bits
            out.append(((v << shifts).sum(1)).astype(np.uint8).tobytes())
        return out
    if bits == 12:
        out = []
        for r in rows:
            v = np.pad(r.astype(np.int64) & 0xFFF, (0, len(r) % 2))
            a, b = v[0::2], v[1::2]
            out.append(np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], 1)
                       .astype(np.uint8).tobytes()[: (len(r) * 12 + 7) // 8])
        return out
    kind = {1: "u", 2: "i", 3: "f"}[sf]
    dt = np.dtype(f"{order}{kind}{bits // 8}")
    if kind != "f":
        if bits < 64:
            rows = rows.astype(np.int64) & ((1 << bits) - 1)
        return [r.astype(np.dtype(f"{order}u{bits // 8}")).tobytes() for r in rows]
    return [r.astype(dt).tobytes() for r in rows]


def _predict(block: np.ndarray, bits: int, sf: int, predictor: int):
    """Horizontal differencing (predictor 2) of integer samples, in place
    of each sample's left neighbour of the same component."""
    if predictor != 2:
        return block
    if bits == 64:
        b = np.asarray(block).astype(np.int64).view(np.uint64)
        d = b.copy()
        d[:, 1:] = b[:, 1:] - b[:, :-1]
        return d
    b = np.asarray(block).astype(np.int64)
    d = b.copy()
    d[:, 1:] = b[:, 1:] - b[:, :-1]
    return d % (1 << bits)


def _fp_predict(rows: list, bits: int, stride: int) -> list:
    """Floating-point predictor (3) of rows of big-endian float bytes:
    bytes regrouped most significant first, then differenced by
    ``stride`` bytes."""
    out = []
    nb = bits // 8
    for r in rows:
        v = np.frombuffer(r, np.uint8).reshape(-1, nb)
        planes = np.ascontiguousarray(v.T).reshape(-1).astype(np.int64)
        d = planes.copy()
        d[stride:] = planes[stride:] - planes[:-stride]
        out.append((d % 256).astype(np.uint8).tobytes())
    return out


def encode_tiff(img, bits: int = 8, photometric: int = 1, sample_format: int = 1,
                extra=(), compression: int = 1, predictor: int = 1, planar: int = 1,
                tile=None, rows_per_strip=None, order: str = "<", bigtiff: bool = False,
                fill_order: int = 1, colormap=None, level: int = 6, orientation=None,
                tags=(), pad: int = 0, codec=None, prefix: bytes = b"",
                squeeze=None) -> bytes:
    """A one-IFD TIFF of ``img`` ((H, W) or (H, W, S) sample values at
    ``bits``): strips of ``rows_per_strip`` rows or ``tile`` (w, h) tiles,
    ``planar`` 1 (chunky) or 2 (one plane per sample), ``order`` "<"
    (II) or ">" (MM), classic or BigTIFF, compression 1, 5 (LZW), 8 /
    32946 (Deflate), 32773 (PackBits), 34925 (LZMA: ``squeeze(data)``, by
    default :func:`xz`) or 50000 (ZSTD: ``squeeze(data)``, by default
    :func:`zstd_compress`), predictor 2 (integer) or 3
    (floating point), fill order 2 (every stored byte bit-reversed),
    ``orientation`` the Orientation tag (274) if given. ``tags``: extra
    (tag, type, values) entries, a rational as its numerator and
    denominator; ``pad``: zero bytes between the image data and the IFD.
    ``codec(block)``: the stored bytes of one strip or tile (its samples,
    (rows, cols, s)) in place of the packing and compression above;
    ``prefix``: bytes written at offset 8 (16 in BigTIFF),
    before the image data (an odd length puts every segment at an odd
    offset)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, S = img.shape
    planes = [img] if planar == 1 else [img[..., i:i + 1] for i in range(S)]
    if tile:
        tw, th = tile
        grid = [(x, y, tw, th) for y in range(0, H, th) for x in range(0, W, tw)]
    else:
        rps = rows_per_strip or H
        grid = [(0, y, W, rps) for y in range(0, H, rps)]
    segments = []
    for plane in planes:
        for x, y, w, h in grid:
            rows_here = h if tile else min(h, H - y)
            blk = np.zeros((rows_here, w, plane.shape[2]), plane.dtype)
            src = plane[y:y + rows_here, x:x + w]
            blk[:src.shape[0], :src.shape[1]] = src
            if codec is not None:
                data = codec(blk)
                if fill_order == 2:
                    data = data.translate(_REVERSED)
                segments.append(data)
                continue
            sf = sample_format
            if sf == 3 and predictor == 2:  # differences of the floats' bit patterns
                blk, sf = blk.astype(f"<f{bits // 8}").view(f"<u{bits // 8}"), 1
            blk = _predict(blk, bits, sf, predictor)
            if sf == 3 and predictor == 3:
                rows = _fp_predict(_pack_samples(blk, bits, 3, ">"), bits, plane.shape[2])
            else:
                rows = _pack_samples(blk, bits, sf, order)
            if compression == 32773:
                data = b"".join(packbits(r) for r in rows)
            elif compression == 5:
                data = lzw(b"".join(rows))
            elif compression in (8, 32946):
                data = zlib.compress(b"".join(rows), level)
            elif compression in (34925, 50000):
                data = (squeeze or (xz if compression == 34925 else zstd_compress))(b"".join(rows))
            else:
                data = b"".join(rows)
            if fill_order == 2:
                data = data.translate(_REVERSED)
            segments.append(data)
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * S), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [S]), (284, 3, [planar])]
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, [int(v) for v in np.asarray(colormap).T.reshape(-1)]))
    if extra:
        entries.append((338, 3, list(extra)))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if sample_format != 1:
        entries.append((339, 3, [sample_format] * S))
    off_type = 16 if bigtiff else 4
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, off_type, None),
                    (325, off_type, [len(s) for s in segments])]
    else:
        entries += [(273, off_type, None), (278, 4, [rows_per_strip or H]),
                    (279, off_type, [len(s) for s in segments])]
    entries += list(tags)
    entries.sort(key=lambda e: e[0])
    e = order
    head = (b"II" if order == "<" else b"MM") + struct.pack(f"{e}H", 43 if bigtiff else 42)
    head += struct.pack(f"{e}HHQ", 8, 0, 0) if bigtiff else struct.pack(f"{e}I", 0)
    head += prefix
    data_at = len(head)
    offsets, pos = [], data_at
    for s in segments:
        offsets.append(pos)
        pos += len(s) + (len(s) & 1)
    body = b"".join(s + b"\0" * (len(s) & 1) for s in segments) + bytes(pad)
    pos += pad
    ifd_at = pos
    n = len(entries)
    ent_size, inline = (20, 8) if bigtiff else (12, 4)
    tail_at = ifd_at + (8 if bigtiff else 2) + n * ent_size + (8 if bigtiff else 4)
    ifd, tail = bytearray(), bytearray()
    ifd += struct.pack(f"{e}Q" if bigtiff else f"{e}H", n)
    for tag, typ, vals in entries:
        if vals is None:
            vals = offsets
        if typ == 2:
            raw = bytes(vals)
        else:
            raw = struct.pack(f"{e}{len(vals)}{TIFF_TYPES[typ]}", *vals)
        count = len(vals) // 2 if typ in (5, 10) else len(vals)
        if len(raw) <= inline:
            val = raw + b"\0" * (inline - len(raw))
        else:
            val = struct.pack(f"{e}Q" if bigtiff else f"{e}I", tail_at + len(tail))
            tail += raw + b"\0" * (len(raw) & 1)
        ifd += struct.pack(f"{e}HHQ" if bigtiff else f"{e}HHI", tag, typ, count) + val
    ifd += b"\0" * (8 if bigtiff else 4)
    head = bytearray(head)
    if bigtiff:
        head[8:16] = struct.pack(f"{e}Q", ifd_at)
    else:
        head[4:8] = struct.pack(f"{e}I", ifd_at)
    return bytes(head) + body + bytes(ifd) + bytes(tail)


# ------------------------------------------------ TIFF's libtiff-only codecs
def jpeg_parts(stream: bytes) -> tuple[list, bytes]:
    """A JPEG's marker segments before its entropy data, [(marker, segment
    bytes)], and the bytes after its SOS header (entropy data, RST markers,
    EOI)."""
    segs, p = [], 2
    while True:
        m = stream[p + 1]
        n = struct.unpack(">H", stream[p + 2:p + 4])[0]
        segs.append((m, stream[p:p + 2 + n]))
        p += 2 + n
        if m == 0xDA:
            return segs, stream[p:]


def split_restarts(entropy: bytes) -> list:
    """Entropy data cut at its RSTn markers (dropped), EOI dropped."""
    out, cur, i = [], bytearray(), 0
    while i < len(entropy):
        b = entropy[i]
        if b == 0xFF and i + 1 < len(entropy) and entropy[i + 1] != 0:
            if 0xD0 <= entropy[i + 1] <= 0xD7:
                out.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
            break  # EOI
        cur.append(b)
        if b == 0xFF:
            cur.append(entropy[i + 1])
            i += 1
        i += 1
    out.append(bytes(cur))
    return out


# every symbol coded: one table for every strip of a TIFF (JPEGTables)
UNIVERSAL_HUFFMAN = {(c, t): optimal_table(np.ones(256, np.int64) if c == "ac"
                                           else (np.arange(256) < 16).astype(np.int64))
                     for c in ("dc", "ac") for t in (0, 1)}


def rgb_to_ycbcr(rgb) -> np.ndarray:
    """uint8 YCbCr of RGB (JFIF's matrix, rounded)."""
    return _rgb_to_ycc(np.asarray(rgb)).astype(np.uint8)


def encode_tiff_jpeg(img, photometric: int = 6, sampling=(2, 2), tables: str = "all",
                     quality: int = 75, restart: int = 0, planar: int = 1, **kw) -> bytes:
    """A new-style JPEG TIFF (compression 7) of ``img`` ((H, W) or (H, W, S)
    sample values as stored: YCbCr for photometric 6, subsampled by
    ``sampling`` in each strip or tile's stream; the other photometrics'
    components as they are, which libtiff does not convert). ``tables``:
    "none" (each stream whole), "dqt" (JPEGTables holds the quantization
    tables, each stream its own Huffman tables) or "all" (JPEGTables holds
    both, a Huffman table of every symbol; the streams hold neither).
    ``restart``: MCUs per restart interval; ``kw``: ``encode_tiff``'s
    layout arguments."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    S = img.shape[2]
    ycc = photometric == 6 and planar == 1
    samp = [tuple(sampling)] + [(1, 1)] * (S - 1) if ycc else None
    qt = {0: quant_table(quality)}
    if S > 1 and planar == 1:
        qt[1] = quant_table(quality, chroma=True)
    huffman = UNIVERSAL_HUFFMAN if tables == "all" else None
    shared, done = {}, []

    def codec(blk):
        if codec.replay:  # the second pass (with JPEGTables) takes the first's streams
            return done[len(done) - codec.replay.pop()]
        planes = [blk[..., i] for i in range(blk.shape[2])]
        q = qt if len(planes) > 1 else {0: qt[0]}
        stream = encode_jpeg(planes, sampling=samp if len(planes) > 1 else None, qtables=q,
                             restart=restart, markers=b"", huffman=huffman)
        segs, rest = jpeg_parts(stream)
        drop = {"none": (), "dqt": (0xDB,), "all": (0xDB, 0xC4)}[tables]
        for m, seg in segs:
            if m in drop:
                shared.setdefault((m, seg), None)
        done.append(b"\xff\xd8" + b"".join(seg for m, seg in segs if m not in drop) + rest)
        return done[-1]

    tags = list(kw.pop("tags", ()))
    if ycc:
        tags.append((530, 3, list(sampling)))
    codec.replay = []
    data = encode_tiff(img, bits=8, photometric=photometric, compression=7, planar=planar,
                       codec=codec, tags=tags, **kw)
    if tables == "none":
        return data
    jt = b"\xff\xd8" + b"".join(seg for _, seg in sorted(shared, key=lambda k: -k[0]))
    codec.replay = list(range(1, len(done) + 1))
    return encode_tiff(img, bits=8, photometric=photometric, compression=7, planar=planar,
                       codec=codec, tags=tags + [(347, 7, list(jt + b"\xff\xd9"))], **kw)


def _subsample_box(plane, hs: int, vs: int) -> np.ndarray:
    """Means of hs × vs boxes (clipped at the edges), rounded."""
    H, W = plane.shape
    out = np.zeros((-(-H // vs), -(-W // hs)))
    for by in range(out.shape[0]):
        for bx in range(out.shape[1]):
            out[by, bx] = plane[by * vs:(by + 1) * vs, bx * hs:(bx + 1) * hs].mean()
    return np.round(out).astype(np.int64)


def ycbcr_blocks(blk, hs: int, vs: int) -> bytes:
    """A strip or tile of YCbCr samples (rows, cols, 3) as TIFF stores it
    subsampled: per block row, ceil(cols / hs) blocks of hs × vs luma
    samples (edge-replicated past the segment), then the box means of Cb
    and Cr."""
    rows, cols = blk.shape[:2]
    br, bc = -(-rows // vs), -(-cols // hs)
    y = np.pad(blk[..., 0], ((0, br * vs - rows), (0, bc * hs - cols)), mode="edge")
    cb, cr = (_subsample_box(blk[..., i].astype(np.float64), hs, vs) for i in (1, 2))
    out = np.zeros((br, bc, hs * vs + 2), np.uint8)
    out[..., :hs * vs] = y.reshape(br, vs, bc, hs).transpose(0, 2, 1, 3).reshape(br, bc, -1)
    out[..., -2], out[..., -1] = cb, cr
    return out.tobytes()


def encode_tiff_ycbcr(ycc, hs: int = 2, vs: int = 2, compression: int = 5,
                      predictor: int = 1, **kw) -> bytes:
    """A YCbCr TIFF (photometric 6) of ``ycc`` (H, W, 3) stored subsampled
    by (``hs``, ``vs``) and compressed with LZW, Deflate or PackBits;
    ``predictor`` 2 differences each TIFFScanlineSize chunk of the packed
    blocks (a block row over ``vs``) three bytes apart, as libtiff undoes
    it; ``kw``: ``encode_tiff``'s layout arguments and tags (YCbCrPositioning,
    ReferenceBlackWhite, YCbCrCoefficients)."""
    tags = list(kw.pop("tags", ())) + [(530, 3, [hs, vs])]
    level = kw.pop("level", 6)
    fill_order = kw.pop("fill_order", 1)

    def codec(blk):
        raw = np.frombuffer(ycbcr_blocks(blk, hs, vs), np.uint8).astype(np.int64)
        if predictor == 2:
            chunk = -(-blk.shape[1] // hs) * (hs * vs + 2) // vs
            rows = raw.reshape(-1, chunk)
            d = rows.copy()
            d[:, 3:] = rows[:, 3:] - rows[:, :-3]
            raw = (d % 256).reshape(-1)
        raw = raw.astype(np.uint8).tobytes()
        if compression == 5:
            return lzw(raw)
        if compression in (8, 32946):
            return zlib.compress(raw, level)
        return packbits(raw)

    return encode_tiff(ycc, photometric=6, compression=compression, predictor=predictor,
                       codec=codec, tags=tags, fill_order=fill_order, **kw)


def _dht_tables(stream: bytes) -> tuple[dict, dict]:
    """A JPEG's quantization tables {id: 64 bytes, zigzag order} and
    Huffman tables {(class, id): 16 counts + symbols}."""
    q, h = {}, {}
    for m, seg in jpeg_parts(stream)[0]:
        body, p = seg[4:], 0
        while m == 0xDB and p < len(body):
            q[body[p] & 15] = body[p + 1:p + 65]
            p += 65
        while m == 0xC4 and p < len(body):
            n = sum(body[p + 1:p + 17])
            h[(body[p] >> 4, body[p] & 15)] = body[p + 1:p + 17 + n]
            p += 17 + n
    return q, h


def encode_tiff_ojpeg(ycc, hs: int = 2, vs: int = 2, rows_per_strip=None,
                      layout: str = "tables", quality: int = 75, photometric: int = 6,
                      **kw) -> bytes:
    """An old-style JPEG TIFF (compression 6) of ``ycc`` (H, W, 3): one
    baseline JPEG of the image (padded by edge rows to whole strips), one
    restart interval a strip, its entropy data cut at the restart markers
    into the strips. ``layout``: "tables" (JPEGQTables, JPEGDCTables,
    JPEGACTables, JPEGProc 1, JPEGRestartInterval, the subsampling tag),
    "jif" (JPEGInterchangeFormat: the stream up to its SOS) or "jif_whole"
    (the whole stream there, the strips after it as well); ``kw``'s tags
    replace the ones of the same number."""
    ycc = np.asarray(ycc)
    H, W = ycc.shape[:2]
    rps = rows_per_strip or H
    total = -(-H // rps) * rps
    full = np.pad(ycc, ((0, total - H), (0, 0), (0, 0)), mode="edge")
    if layout != "tables":
        full = full[:H]
    restart = -(-W // (8 * hs)) * (rps // (8 * vs)) if rps < H else 0
    stream = encode_jpeg([full[..., i] for i in range(3)], sampling=[(hs, vs), (1, 1), (1, 1)],
                         ids=[0, 1, 2], quality=quality, restart=restart, markers=b"")
    segs, rest = jpeg_parts(stream)
    strips = split_restarts(rest)
    override = list(kw.pop("tags", ()))
    tags = []
    if layout == "tables":
        q, h = _dht_tables(stream)
        blob, at = b"", []
        for part in (q[0], q[1], h[(0, 0)], h[(0, 1)], h[(1, 0)], h[(1, 1)]):
            at.append(8 + len(blob))
            blob += part + b"\0" * (len(part) & 1)
        tags += [(512, 3, [1]), (519, 4, [at[0], at[1], at[1]]), (520, 4, [at[2], at[3], at[3]]),
                 (521, 4, [at[4], at[5], at[5]]), (515, 3, [restart]), (530, 3, [hs, vs])]
    else:
        blob = stream if layout == "jif_whole" else stream[:len(stream) - len(rest)]
        tags += [(513, 4, [8]), (514, 4, [len(blob)])]
    tags = [t for t in tags if t[0] not in {o[0] for o in override}] + override
    it = iter(strips)
    return encode_tiff(ycc, photometric=photometric, compression=6, rows_per_strip=rps,
                       codec=lambda blk: next(it), prefix=blob, tags=tags, **kw)


# ------------------------------------------------------------- CCITT fax
# T.4's run codes as (bits, length), by run: terminating 0-63, make-up
# 64-1728 by 64, the extended make-up 1792-2560 of both colours
_FAX_WHITE = ["00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011",
              "10100", "00111", "01000", "001000", "000011", "110100", "110101", "101010",
              "101011", "0100111", "0001100", "0001000", "0010111", "0000011", "0000100",
              "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011",
              "00011010", "00011011", "00010010", "00010011", "00010100", "00010101",
              "00010110", "00010111", "00101000", "00101001", "00101010", "00101011",
              "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
              "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
              "01011000", "01011001", "01011010", "01011011", "01001010", "01001011",
              "00110010", "00110011", "00110100"]
_FAX_WHITE_MAKEUP = ["11011", "10010", "010111", "0110111", "00110110", "00110111",
                     "01100100", "01100101", "01101000", "01100111", "011001100", "011001101",
                     "011010010", "011010011", "011010100", "011010101", "011010110",
                     "011010111", "011011000", "011011001", "011011010", "011011011",
                     "010011000", "010011001", "010011010", "011000", "010011011"]
_FAX_BLACK = ["0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101",
              "000100", "0000100", "0000101", "0000111", "00000100", "00000111", "000011000",
              "0000010111", "0000011000", "0000001000", "00001100111", "00001101000",
              "00001101100", "00000110111", "00000101000", "00000010111", "00000011000",
              "000011001010", "000011001011", "000011001100", "000011001101", "000001101000",
              "000001101001", "000001101010", "000001101011", "000011010010", "000011010011",
              "000011010100", "000011010101", "000011010110", "000011010111", "000001101100",
              "000001101101", "000011011010", "000011011011", "000001010100", "000001010101",
              "000001010110", "000001010111", "000001100100", "000001100101", "000001010010",
              "000001010011", "000000100100", "000000110111", "000000111000", "000000100111",
              "000000101000", "000001011000", "000001011001", "000000101011", "000000101100",
              "000001011010", "000001100110", "000001100111"]
_FAX_BLACK_MAKEUP = ["0000001111", "000011001000", "000011001001", "000001011011",
                     "000000110011", "000000110100", "000000110101", "0000001101100",
                     "0000001101101", "0000001001010", "0000001001011", "0000001001100",
                     "0000001001101", "0000001110010", "0000001110011", "0000001110100",
                     "0000001110101", "0000001110110", "0000001110111", "0000001010010",
                     "0000001010011", "0000001010100", "0000001010101", "0000001011010",
                     "0000001011011", "0000001100100", "0000001100101"]
_FAX_EXT_MAKEUP = ["00000001000", "00000001100", "00000001101", "000000010010",
                   "000000010011", "000000010100", "000000010101", "000000010110",
                   "000000010111", "000000011100", "000000011101", "000000011110",
                   "000000011111"]
_FAX_EOL = "000000000001"
_FAX_MODES = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011", 3: "0000011",
              -1: "010", -2: "000010", -3: "0000010"}


def _fax_run(run: int, black: bool) -> str:
    term, makeup = (_FAX_BLACK, _FAX_BLACK_MAKEUP) if black else (_FAX_WHITE, _FAX_WHITE_MAKEUP)
    out = ""
    while run >= 2560 + 64:
        out += _FAX_EXT_MAKEUP[-1]
        run -= 2560
    if run >= 64:
        m = run // 64 * 64
        out += makeup[m // 64 - 1] if m <= 1728 else _FAX_EXT_MAKEUP[(m - 1792) // 64]
        run -= m
    return out + term[run]


def _fax_changes(row) -> list:
    """Positions where the colour changes (from white, 0, at -1), then the
    row's width twice (T.4's a1 / b1 past the end)."""
    row = np.asarray(row, np.int64)
    prev = np.concatenate([[0], row[:-1]])
    ch = list(np.nonzero(row != prev)[0])
    return ch + [len(row), len(row)]


def _fax_1d(row) -> str:
    out, colour, x = "", 0, 0
    for c in _fax_changes(row)[:-2] + [len(row)]:
        out += _fax_run(c - x, bool(colour))
        colour ^= 1
        x = c
    return out


def _fax_2d(row, ref) -> str:
    """T.4 / T.6 two-dimensional coding of ``row`` against ``ref``."""
    W = len(row)
    cur, refc = _fax_changes(row)[:-2], _fax_changes(ref)[:-2]
    out, a0, colour = [], -1, 0
    while a0 < W:
        i = bisect.bisect_right(cur, a0)  # a1: the next change right of a0
        a1 = cur[i] if i < len(cur) else W
        a2 = cur[i + 1] if i + 1 < len(cur) else W
        j = bisect.bisect_right(refc, a0)  # b1: the next opposite-colour change above
        if j < len(refc) and j % 2 != colour:
            j += 1
        b1 = refc[j] if j < len(refc) else W
        b2 = refc[j + 1] if j + 1 < len(refc) else W
        if b2 < a1:  # pass
            out.append(_FAX_MODES["P"])
            a0 = b2
        elif abs(a1 - b1) <= 3:  # vertical
            out.append(_FAX_MODES[a1 - b1])
            a0 = a1
            colour ^= 1
        else:  # horizontal
            out.append(_FAX_MODES["H"] + _fax_run(a1 - max(a0, 0), bool(colour))
                       + _fax_run(a2 - a1, not colour))
            a0 = a2
    return "".join(out)


def pil_dither(u8) -> np.ndarray:
    """PIL's ``convert("1")`` of an 8-bit gray image (Convert.c's
    Floyd-Steinberg ``tobilevel``, integer errors in sixteenths), as
    (H, W) bool (True: white), without PIL."""
    u8 = np.asarray(u8, np.int64)
    H, W = u8.shape
    out = np.zeros((H, W), bool)
    errors = [0] * (W + 1)
    for y in range(H):
        row = u8[y].tolist()
        o = [False] * W
        l = l0 = l1 = 0
        for x in range(W):
            v = row[x] + (l + errors[x + 1]) // 16 if l + errors[x + 1] >= 0 \
                else row[x] - (-(l + errors[x + 1]) // 16)
            v = 0 if v < 0 else 255 if v > 255 else v
            white = v > 128
            o[x] = white
            l = v - (255 if white else 0)
            l2 = l
            d2 = l + l
            l += d2
            errors[x] = l + l0
            l += d2
            l0 = l + l1
            l1 = l2
            l += d2
        errors[W] = l0
        out[y] = o
    return out


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def fax_encode(bits, compression: int, options: int = 0, rtc: bool = True,
               two_d_every: int = 2) -> bytes:
    """CCITT coding of a (rows, cols) 0/1 array (1: a black run), MSB
    first: 2 (Modified Huffman, rows byte-aligned), 32771 (the same,
    word-aligned), 3 (Group 3: an EOL before each row; ``options`` bit 0:
    2D, every ``two_d_every``-th row 1D, the tag bit after each EOL; bit 2:
    fill bits that end each EOL on a byte boundary; ``rtc``: six EOLs at the
    end) or 4 (Group 4, an EOFB at the end)."""
    bits = np.asarray(bits).reshape(len(bits), -1).astype(np.int64)
    W = bits.shape[1]
    out, ref = "", np.zeros(W, np.int64)
    for i, row in enumerate(bits):
        if compression in (2, 32771):
            out += _fax_1d(row)
            align = 8 if compression == 2 else 16
            out += "0" * (-len(out) % align)
            continue
        if compression == 4:
            out += _fax_2d(row, ref)
            ref = row
            continue
        eol = _FAX_EOL
        if options & 4:  # fill bits: the EOL ends on a byte boundary
            extra = 1 if options & 1 else 0
            out += "0" * ((-(len(out) + len(eol) + extra)) % 8)
        out += eol
        if options & 1:
            one_d = i % two_d_every == 0
            out += "1" if one_d else "0"
            out += _fax_1d(row) if one_d else _fax_2d(row, ref)
        else:
            out += _fax_1d(row)
        ref = row
    if compression == 4:
        out += _FAX_EOL * 2
    elif compression == 3 and rtc:
        out += (_FAX_EOL + ("1" if options & 1 else "")) * 6
    return _bits_to_bytes(out)


def encode_tiff_fax(bits, compression: int = 4, photometric: int = 0, options: int = 0,
                    rtc: bool = True, corrupt=None, **kw) -> bytes:
    """A bilevel CCITT TIFF of ``bits`` (1: black-coded runs); ``options``
    the T4Options (3) or T6Options (4) tag; ``corrupt(data) -> data`` alters
    each strip's stored bytes; ``kw``: ``encode_tiff``'s layout arguments."""
    tags = list(kw.pop("tags", ()))
    if compression in (3, 4) and options:
        tags.append((292 if compression == 3 else 293, 4, [options]))

    def codec(blk):
        data = fax_encode(blk[..., 0], compression, options, rtc)
        return corrupt(data) if corrupt else data

    return encode_tiff(np.asarray(bits, np.int64), bits=1, photometric=photometric,
                       compression=compression, codec=codec, tags=tags, **kw)


# ------------------------------------- TIFF's LZMA, ZSTD and ThunderScan
def xz(data: bytes, check: int = None, preset: int = 6, filters=None) -> bytes:
    """``data`` as one .xz stream (the standard library's ``lzma``; check
    CRC64 by default, ``filters`` a filter chain in place of ``preset``)."""
    import lzma

    check = lzma.CHECK_CRC64 if check is None else check
    if filters is not None:
        return lzma.compress(data, lzma.FORMAT_XZ, check, filters=filters)
    return lzma.compress(data, lzma.FORMAT_XZ, check, preset)


def _pillow_lib(stem: str):
    """ctypes handle of one of Pillow's bundled libraries, or None."""
    import ctypes
    import glob

    import PIL._imaging  # noqa: F401  (loads the bundled libraries)

    pattern = os.path.join(os.path.dirname(os.path.dirname(PIL._imaging.__file__)),
                           "pillow.libs", f"{stem}-*.so*")
    found = sorted(glob.glob(pattern))
    return ctypes.CDLL(found[0]) if found else None


def liblzma_xz(data: bytes, filter_ids, check: int = 4, preset: int = 6) -> bytes:
    """``data`` as one .xz stream through Pillow's bundled liblzma
    (``lzma_stream_buffer_encode``): the chain ``filter_ids`` (BCJ ids 4-11,
    default options) before LZMA2 at ``preset``, for the filters the
    standard library's ``lzma`` does not name (ARM64 10, RISC-V 11)."""
    import ctypes

    lib = _pillow_lib("liblzma")
    opts = ctypes.create_string_buffer(512)
    assert lib.lzma_lzma_preset(opts, ctypes.c_uint32(preset)) == 0

    class Filter(ctypes.Structure):
        _fields_ = [("id", ctypes.c_uint64), ("options", ctypes.c_void_p)]

    chain = (Filter * (len(filter_ids) + 2))()
    for i, fid in enumerate(filter_ids):
        chain[i] = Filter(fid, None)
    chain[len(filter_ids)] = Filter(0x21, ctypes.cast(opts, ctypes.c_void_p))
    chain[len(filter_ids) + 1] = Filter(2**64 - 1, None)
    out = ctypes.create_string_buffer(len(data) * 2 + 1024)
    pos = ctypes.c_size_t(0)
    rc = lib.lzma_stream_buffer_encode(chain, ctypes.c_int(check), None, data,
                                       ctypes.c_size_t(len(data)), out, ctypes.byref(pos),
                                       ctypes.c_size_t(len(out)))
    assert rc == 0, rc
    return out.raw[:pos.value]


def zstd_compress(data: bytes, level: int = 3, checksum: bool = False, window_log: int = 0,
                  content_size: bool = True) -> bytes:
    """``data`` as one Zstandard frame through Pillow's bundled libzstd:
    ``level``, the XXH64 ``checksum``, ``window_log`` (0: libzstd's
    choice); without ``content_size`` the frame states no size and is
    written through the streaming API, so the window is not cut to the
    input."""
    import ctypes

    lib = _pillow_lib("libzstd")
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    cctx = ctypes.c_void_p(lib.ZSTD_createCCtx())
    try:
        for param, value in ((100, level), (201, int(checksum)), (101, window_log),
                             (200, int(content_size))):
            rc = lib.ZSTD_CCtx_setParameter(cctx, param, value)
            assert not lib.ZSTD_isError(ctypes.c_size_t(rc)), (param, value)
        cap = lib.ZSTD_compressBound(ctypes.c_size_t(len(data))) + 64
        out = ctypes.create_string_buffer(cap)
        if content_size:
            lib.ZSTD_compress2.restype = ctypes.c_size_t
            n = lib.ZSTD_compress2(cctx, out, ctypes.c_size_t(cap), data,
                                   ctypes.c_size_t(len(data)))
            assert not lib.ZSTD_isError(ctypes.c_size_t(n))
            return out.raw[:n]

        class Buf(ctypes.Structure):
            _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                        ("pos", ctypes.c_size_t)]

        src = ctypes.create_string_buffer(data, len(data))
        ib, ob = Buf(ctypes.cast(src, ctypes.c_void_p), len(data), 0), \
            Buf(ctypes.cast(out, ctypes.c_void_p), cap, 0)
        lib.ZSTD_compressStream2.restype = ctypes.c_size_t
        for end in (0, 2):  # ZSTD_e_continue with the data, then ZSTD_e_end
            while True:
                left = lib.ZSTD_compressStream2(cctx, ctypes.byref(ob), ctypes.byref(ib), end)
                assert not lib.ZSTD_isError(ctypes.c_size_t(left))
                if end == 0 or left == 0:
                    break
        return out.raw[:ob.pos]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (Zstandard's content checksum is its low 32 bits)."""
    M = (1 << 64) - 1
    P1, P2, P3, P4, P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                          0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def rnd(acc, v):
        return rotl((acc + v * P2) & M, 31) * P1 & M

    n, i = len(data), 0
    if n >= 32:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed, (seed - P1) & M]
        while i + 32 <= n:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[i + 8 * k:i + 8 * k + 8], "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
        for k in range(4):
            h = ((h ^ rnd(0, v[k])) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * P1 + P4) & M
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * P1 & M), 23) * P2 + P3) & M
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * P5 & M), 11) * P1 & M
        i += 1
    h ^= h >> 33
    h = h * P2 & M
    h ^= h >> 29
    h = h * P3 & M
    return h ^ (h >> 32)


class _BackBits:
    """A Zstandard backward bitstream: values appended low bits first, the
    reader taking the last written first; ``bytes`` closes it with the
    marker bit."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def add(self, value: int, bits: int):
        self.acc |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits

    def bytes(self) -> bytes:
        acc = self.acc | (1 << self.n)
        return acc.to_bytes((self.n + 8) // 8, "little")


def _lit_header(kind: int, size: int, csize: int = 0, four: bool = False) -> bytes:
    """A literals section header: raw (0) / RLE (1) of ``size``, or Huffman
    (2) / treeless (3) of ``size`` regenerated and ``csize`` stored bytes in
    one or ``four`` streams."""
    if kind < 2:
        if size < 32:
            return bytes([kind | size << 3])
        if size < 4096:
            return struct.pack("<H", kind | 1 << 2 | size << 4)
        return (kind | 3 << 2 | size << 4).to_bytes(3, "little")
    big = max(size, csize)
    lhl = (1 if four else 0) if big < 1024 else 2 if big < 16384 else 3
    width = {0: 10, 1: 10, 2: 14, 3: 18}[lhl]
    v = kind | lhl << 2 | size << 4 | csize << (4 + width)
    return v.to_bytes({0: 3, 1: 3, 2: 4, 3: 5}[lhl], "little")


def huffman_weights(lits: bytes) -> list:
    """Zstandard Huffman weights (index: byte value) of ``lits``, at least
    two symbols, no code past 11 bits."""
    freq = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
    used = np.nonzero(freq)[0]
    if len(used) < 2:
        freq[(int(used[0]) + 1) % 128 if len(used) else 0] = 1
    lengths = huffman_lengths(freq, 11)
    top = max(lengths)
    return [top + 1 - L if L else 0 for L in lengths]


def _huffman_codes(weights) -> tuple:
    """(code, length) of each symbol: lower weights first, by symbol."""
    log = sum(1 << (w - 1) for w in weights if w).bit_length() - 1
    codes, start = {}, 0
    for w in range(1, log + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                codes[s] = (start >> (w - 1), log + 1 - w)
                start += 1 << (w - 1)
    return codes


def _huffman_stream(lits: bytes, codes) -> bytes:
    bits = _BackBits()
    for b in reversed(lits):
        c, n = codes[b]
        bits.add(c, n)
    return bits.bytes()


def zstd_literals(lits: bytes, mode: str, weights=None) -> bytes:
    """A literals section of ``lits``: "raw", "rle" (all one byte),
    "huff1" / "huff4" (a direct weights table: byte values under 128; the
    table is ``weights`` if given) or "tree1" / "tree4" (treeless: the
    previous block's ``weights``)."""
    if mode == "raw":
        return _lit_header(0, len(lits)) + lits
    if mode == "rle":
        return _lit_header(1, len(lits)) + lits[:1]
    four = mode.endswith("4")
    codes = _huffman_codes(weights)
    if four:
        seg = (len(lits) + 3) // 4
        streams = [_huffman_stream(lits[k * seg:(k + 1) * seg], codes) for k in range(4)]
        body = struct.pack("<3H", *(len(x) for x in streams[:3])) + b"".join(streams)
    else:
        body = _huffman_stream(lits, codes)
    if mode.startswith("huff"):
        last = max(s for s, w in enumerate(weights) if w)
        assert last < 128
        ws = list(weights[:last]) + [0] * (last & 1)
        body = bytes([127 + last]) + bytes(ws[k] << 4 | ws[k + 1] for k in range(0, last, 2)) \
            + body
    return _lit_header(2 if mode.startswith("huff") else 3, len(lits), len(body), four) + body


def _zstd_code(value: int, base, extra) -> tuple:
    """The (code, extra bits value) of a literal or match length."""
    for code in range(len(base) - 1, -1, -1):
        if value >= base[code]:
            assert value - base[code] < 1 << extra[code]
            return code, value - base[code]
    raise ValueError(value)


ZSTD_LL_BASE = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24, 28,
                32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536]
ZSTD_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ZSTD_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                     1027, 2051, 4099, 8195, 16387, 32771, 65539]
ZSTD_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def zstd_sequences(seqs, modes=("rle", "rle", "rle")) -> bytes:
    """A sequences section of ``seqs`` [(literal length, match length,
    offset value)] (an offset value is the offset + 3, or 1-3 for a repeat
    offset) with every table in RLE mode (each of the three codes the same
    in every sequence) or "repeat" mode (the previous block's)."""
    n = len(seqs)
    out = bytes([n]) if n < 128 else struct.pack(">H", 0x8000 | n) if n < 0x7F00 else \
        b"\xff" + struct.pack("<H", n - 0x7F00)
    if n == 0:
        return out
    coded = []
    for ll, ml, ofv in seqs:
        llc, llx = _zstd_code(ll, ZSTD_LL_BASE, ZSTD_LL_BITS)
        mlc, mlx = _zstd_code(ml, ZSTD_ML_BASE, ZSTD_ML_BITS)
        ofc = ofv.bit_length() - 1
        coded.append((llc, llx, mlc, mlx, ofc, ofv - (1 << ofc)))
    mode_bits = {"rle": 1, "repeat": 3}
    out += bytes([mode_bits[modes[0]] << 6 | mode_bits[modes[1]] << 4 | mode_bits[modes[2]] << 2])
    for k, m in ((0, modes[0]), (4, modes[1]), (2, modes[2])):
        codes = {c[k] for c in coded}
        assert len(codes) == 1, "one code per table in RLE mode"
        if m == "rle":
            out += bytes([codes.pop()])
    bits = _BackBits()
    for llc, llx, mlc, mlx, ofc, ofx in reversed(coded):
        bits.add(llx, ZSTD_LL_BITS[llc])
        bits.add(mlx, ZSTD_ML_BITS[mlc])
        bits.add(ofx, ofc)
    return out + bits.bytes()


def zstd_block(kind: str, body: bytes, last: bool, rle_size: int = 0) -> bytes:
    """A block header and body: "raw", "rle" (``body`` one byte repeated
    ``rle_size`` times) or "compressed"."""
    t = {"raw": 0, "rle": 1, "compressed": 2}[kind]
    size = rle_size if kind == "rle" else len(body)
    return (int(last) | t << 1 | size << 3).to_bytes(3, "little") + body


def zstd_frame(blocks: bytes, content: bytes = None, checksum: bool = False,
               window_log: int = None, dict_id: int = 0) -> bytes:
    """A Zstandard frame of ``blocks`` (their bytes): single segment where
    ``window_log`` is None (``content`` the decoded bytes, whose size and
    XXH64 the header and ``checksum`` state), else a window descriptor and
    the content size where ``content`` is given."""
    fhd, tail = int(checksum) << 2, b""
    if dict_id:
        fhd |= 3
        tail += struct.pack("<I", dict_id)
    if window_log is None:
        size = len(content)
        fhd |= 1 << 5
        fcs = bytes([size]) if size < 256 else struct.pack("<H", size - 256) if size < 65792 \
            else struct.pack("<I", size)
        fhd |= (0 if size < 256 else 1 if size < 65792 else 2) << 6
        head = bytes([fhd]) + tail + fcs
    else:
        fcs = b"" if content is None else struct.pack("<I", len(content))
        fhd |= (2 << 6) if content is not None else 0
        head = bytes([fhd, (window_log - 10) << 3]) + tail + fcs
    out = b"\x28\xb5\x2f\xfd" + head + blocks
    if checksum:
        out += struct.pack("<I", xxh64(content) & 0xFFFFFFFF)
    return out


def zstd_skippable(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 + nibble, len(payload)) + payload


def zstd_writer_frame(rng, size: int, checksum: bool = None) -> tuple:
    """A frame of blocks of every kind the writer has, chosen by ``rng``,
    whose content is ``size`` bytes: (frame, content). Blocks: raw, RLE,
    and compressed ones with raw, RLE, Huffman (1 or 4 streams) or treeless
    literals, and sequences (literal lengths 16-17, match lengths 35-36; in
    a block either new offsets of one code or repeat offsets of one code)
    with RLE tables or the previous block's (repeat mode)."""
    content = bytearray()
    blocks, weights, tables = [], None, None
    reps = [1, 4, 8]
    while len(content) < size:
        left = size - len(content)
        kind = str(rng.choice(["raw", "rle", "compressed", "compressed", "compressed"]))
        n = int(min(left, rng.integers(1, 400)))
        if kind == "raw":
            data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
            blocks.append(("raw", data, 0))
            content += data
            continue
        if kind == "rle":
            b = bytes([int(rng.integers(0, 256))])
            blocks.append(("rle", b, n))
            content += b * n
            continue
        out, seqs, lits, new_reps = bytearray(content), [], bytearray(), list(reps)
        if len(out) >= 64 and rng.random() < 0.7:
            how = str(rng.choice(["new", "rep0", "rep12"]))
            ofc = int(rng.integers(2, 7))
            while len(out) - len(content) + 60 <= n:
                ll, ml = int(rng.integers(16, 18)), int(rng.integers(35, 37))
                lit = rng.integers(0, 100, ll).astype(np.uint8).tobytes()
                r = new_reps
                if how == "new":
                    ofv = (1 << ofc) + int(rng.integers(0, 1 << ofc))
                    off, cand = ofv - 3, [ofv - 3, r[0], r[1]]
                elif how == "rep0":
                    ofv, off, cand = 1, r[0], list(r)
                else:
                    ofv = int(rng.integers(2, 4))
                    off = r[ofv - 1]
                    cand = [r[1], r[0], r[2]] if ofv == 2 else [r[2], r[0], r[1]]
                if not 0 < off <= len(out) + ll:
                    break
                out += lit
                for _ in range(ml):
                    out.append(out[-off])
                seqs.append((ll, ml, ofv))
                lits += lit
                new_reps = cand
        tail = rng.integers(0, 100, n if not seqs else int(rng.integers(0, 20)))
        tail = tail.astype(np.uint8).tobytes()
        if not seqs and rng.random() < 0.2:
            tail = tail[:1] * len(tail)
        lits += tail
        out += tail
        data_out = bytes(out[len(content):])
        if not data_out or len(data_out) > left:
            continue
        lits = bytes(lits)
        lmode = str(rng.choice(["raw", "huff1", "huff4", "tree1", "tree4"] +
                               (["rle"] if lits and len(set(lits)) == 1 else [])))
        if lmode.startswith("tree") and (weights is None or
                                         any(weights[b] == 0 for b in set(lits))):
            lmode = "huff" + lmode[-1]
        if lmode.endswith("4") and len(lits) < 6 or not lits and lmode != "raw":
            lmode = "raw"
        if lmode.startswith("huff"):
            weights = huffman_weights(lits)
        section = zstd_literals(lits, lmode, weights)
        if seqs:
            ll, ml, ofv = seqs[0]
            codes = (_zstd_code(ll, ZSTD_LL_BASE, ZSTD_LL_BITS)[0], ofv.bit_length() - 1,
                     _zstd_code(ml, ZSTD_ML_BASE, ZSTD_ML_BITS)[0])
            modes = tuple("repeat" if tables == codes and rng.random() < 0.6 else "rle"
                          for _ in range(3))
            section += zstd_sequences(seqs, modes)
            tables = codes
            reps = new_reps
        else:
            section += b"\0"
        blocks.append(("compressed", section, 0))
        content += data_out
    body = b"".join(zstd_block(k, b, i == len(blocks) - 1, r)
                    for i, (k, b, r) in enumerate(blocks))
    if checksum is None:
        checksum = bool(rng.random() < 0.5)
    # a window of at least the content (a single segment's window is the
    # content size, which a compressed block may not outgrow)
    window_log = max(10, (size - 1).bit_length())
    return zstd_frame(body, bytes(content), checksum, window_log), bytes(content)


def thunder_encode(rows, rng=None) -> bytes:
    """ThunderScan bytes of 4-bit ``rows`` (H, W): each row from pixel 0
    with the last pixel 0, as runs (1-63), three 2-bit or two 3-bit deltas
    (mod 16, with their skip codes where ``rng`` inserts them) or raw
    pixels, ``rng`` choosing among the codes that fit."""
    rng = rng or np.random.default_rng(0)
    out = bytearray()
    two = {0: 0, 1: 1, 15: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    for row in np.asarray(rows, np.int64):
        last, i, W = 0, 0, len(row)
        while i < W:
            opts = ["raw"]
            run = 0
            while i + run < W and run < 63 and row[i + run] == last:
                run += 1
            if run:
                opts.append("run")
            d = [(int(row[i + k]) - prev) % 16 for k, prev in
                 zip(range(3), [last] + [int(v) for v in row[i:i + 2]]) if i + k < W]
            if len(d) == 3 and all(x in two for x in d):
                opts.append("two")
            if len(d) >= 2 and all(x in three for x in d[:2]):
                opts.append("three")
            if len(d) >= 1 and d[0] in two:
                opts.append("two1")
            if len(d) >= 1 and d[0] in three:
                opts.append("three1")
            pick = opts[int(rng.integers(0, len(opts)))]
            if pick == "run":
                k = int(rng.integers(1, run + 1))
                out.append(k)
                i += k
            elif pick == "two":
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                i += 3
            elif pick == "three":
                out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                i += 2
            elif pick == "two1":  # one delta among two skip codes
                slot = int(rng.integers(0, 3))
                f = [2, 2, 2]
                f[slot] = two[d[0]]
                out.append(0x40 | f[0] << 4 | f[1] << 2 | f[2])
                i += 1
            elif pick == "three1":
                f = [4, 4]
                f[int(rng.integers(0, 2))] = three[d[0]]
                out.append(0x80 | f[0] << 3 | f[1])
                i += 1
            else:
                out.append(0xC0 | int(row[i]))
                i += 1
            last = int(row[i - 1])
    return bytes(out)


def encode_tiff_thunder(img4, photometric: int = 1, rng=None, corrupt=None, **kw) -> bytes:
    """A ThunderScan TIFF (compression 32809) of 4-bit ``img4`` (H, W);
    ``corrupt(data) -> data`` alters each strip's stored bytes; ``kw``:
    ``encode_tiff``'s layout arguments (``bits`` other than 4 declares
    another depth over the same data)."""
    bits = kw.pop("bits", 4)

    def codec(blk):
        data = thunder_encode(blk[..., 0], rng)
        return corrupt(data) if corrupt else data

    return encode_tiff(np.asarray(img4, np.int64), bits=bits, photometric=photometric,
                       compression=32809, codec=codec, **kw)


# ------------------------------------------------------------------- BMP
def rle_encode(rows, rle4: bool, stop_early=None, delta_at=None) -> bytes:
    """RLE8 / RLE4 pixel data of index ``rows`` in stored order: runs of
    equal indices encoded, stretches of 3 or more without a repeat in
    absolute mode (word-aligned), an end-of-line after each row and an
    end-of-bitmap at the end (after ``stop_early`` rows, if given).
    ``delta_at``: (row, dx, dy) puts a delta escape before that row."""
    out = bytearray()
    for ri, row in enumerate(rows):
        if stop_early is not None and ri == stop_early:
            break
        if delta_at is not None and delta_at[0] == ri:
            out += bytes([0, 2, delta_at[1], delta_at[2]])
        row = [int(v) & (15 if rle4 else 255) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i + 1
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 2 or n - i < 3:
                out += bytes([j - i, row[i] * 17 if rle4 else row[i]])
                i = j
                continue
            j = i + 1
            while j < n and j - i < 255 and row[j] != row[j - 1]:
                j += 1
            if j < n and row[j] == row[j - 1]:
                j -= 1
            if j - i < 3:
                out += bytes([1, row[i] * 17 if rle4 else row[i]])
                i += 1
                continue
            lit = row[i:j]
            if rle4:
                lit = lit + [0] * (len(lit) % 2)
                data = bytes((lit[k] << 4) | lit[k + 1] for k in range(0, len(lit), 2))
            else:
                data = bytes(lit)
            out += bytes([0, j - i]) + data + b"\0" * (len(data) & 1)
            i = j
        out += b"\0\0"
    out += b"\0\1"
    return bytes(out)


def encode_bmp(pixels, bits: int, header: int = 40, compression: int = 0, palette=None,
               masks=None, top_down: bool = False, colors=None, pad_palette: bool = True,
               rle=None, data_offset=None) -> bytes:
    """A BMP of ``pixels``: (H, W) palette indices (bits ≤ 8), (H, W)
    16-bit words (bits 16), or (H, W, 3|4) RGB(A) (24, 32), written
    bottom-up unless ``top_down``. ``header``: 12 (OS/2 1.x), 40, 52, 56,
    64 (OS/2 2.x), 108, 124. ``palette``: (N, 3) RGB; ``masks``: the
    BITFIELDS masks (R, G, B[, A]); ``rle``: the pixel data bytes for
    compression 1 or 2 (:func:`rle_encode`)."""
    pixels = np.asarray(pixels)
    H, W = pixels.shape[:2]
    rows = pixels[::-1] if not top_down else pixels
    if rle is not None:
        data = rle
    else:
        stride = ((W * bits + 31) >> 3) & ~3
        out = bytearray()
        for r in rows:
            if bits <= 8:
                v = r.astype(np.uint8)
                per = 8 // bits
                v = np.pad(v, (0, -len(v) % per)).reshape(-1, per)
                raw = ((v << (np.arange(per - 1, -1, -1) * bits)).sum(1)).astype(np.uint8).tobytes()
            elif bits == 16:
                raw = r.astype("<u2").tobytes()
            elif bits == 24:
                raw = r[:, 2::-1].astype(np.uint8).tobytes()
            else:  # 32: B, G, R and the fourth sample (or 0)
                fourth = r[:, 3:] if r.shape[1] > 3 else np.zeros((W, 1), r.dtype)
                raw = np.concatenate([r[:, 2::-1], fourth], 1).astype(np.uint8).tobytes()
            out += raw + b"\0" * (stride - len(raw))
        data = bytes(out)
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"\0" if header != 12 else b"")
                       for r, g, b in np.asarray(palette, np.int64))
    height = -H if top_down else H
    if header == 12:
        info = struct.pack("<IHHHH", 12, W, H, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, W, height, 1, bits, compression, len(data),
                           2835, 2835, colors if colors is not None else
                           (0 if palette is None else len(palette)), 0)
        if header >= 52 and masks is not None:
            k = 4 if header >= 56 else 3
            info += struct.pack(f"<{k}I", *(list(masks) + [0] * (4 - len(masks)))[:k])
        info = info + b"\0" * (header - len(info))
        if header == 40 and masks is not None:
            info += struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(pal) if data_offset is None else data_offset
    size = offset + len(data)
    return b"BM" + struct.pack("<IHHI", size, 0, 0, offset) + info + pal + data


# ------------------------------------------------------------------- PFM
def encode_pfm(img, scale: float = -1.0) -> bytes:
    """A gray PFM ("Pf") of float ``img``: little-endian for a negative
    scale, big-endian for a positive one, rows bottom to top."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    dt = "<f4" if scale < 0 else ">f4"
    return b"Pf\n%d %d\n%s\n" % (W, H, repr(float(scale)).encode()) + \
        img[::-1].astype(dt).tobytes()


# ------------------------------------------------------------------ content
def scene(H: int, W: int, seed: int, channels: int = 1) -> np.ndarray:
    """Smooth shapes, an edge and mild noise: image-like content that
    exercises every coefficient. (H, W) or (H, W, channels) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    out = []
    for ch in range(channels):
        a = rng.uniform(0.02, 0.25, 4)
        img = (128 + 60 * np.sin(a[0] * x + a[1] * y + ch) + 40 * np.cos(a[2] * x * y / 8 + a[3] * y)
               + 70 * ((x - W * rng.uniform(0.2, 0.8)) * rng.uniform(-1, 1) + y - H / 2 > 0)
               - 35 + rng.normal(0, 6, (H, W)))
        out.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    return out[0] if channels == 1 else np.stack(out, -1)


def pil_sha256(path_or_bytes) -> str:
    from PIL import Image

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with Image.open(src) as im:
        arr = np.asarray(im.convert("L"))
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


# ------------------------------------------------------------------ fixtures
W_SMALL, H_SMALL = 64, 48
# the word each refused fixture's refusal names it by; "pil_reads": PIL
# reads the file, the port refuses it (a kind or format not ported yet)
REFUSED = {"jpeg_12bit": "not 8-bit", "jpeg_hierarchical": "hierarchical", "jpeg_dnl": "DNL",
           "jpeg_fractional_sampling": "fractional sampling"}


# ------------------------------------------------------------------- GIF
def gif_lzw(indices, code_size: int, end_code: bool = True, end_after=None) -> bytes:
    """GIF's LZW of ``indices`` at the initial ``code_size``: LSB-first
    codes, a Clear first, the code width growing as the decoder's table
    reaches 2**width - 1 (it adds its entry one code behind the encoder),
    a Clear when the table holds 4096 entries, then the End code unless
    ``end_code`` is false; an early End code after ``end_after`` codes
    when given (the stream goes on after it). Returns the bytes before
    sub-blocking."""
    clear, end = 1 << code_size, (1 << code_size) + 1
    out = bytearray()
    acc = nacc = 0
    state = {"width": code_size + 1, "emitted": 0}

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += state["width"]
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def emit(code):
        put(code)
        state["total"] = state.get("total", 0) + 1
        if state["total"] == end_after:
            put(end)  # an End code changes no decoder state
        state["emitted"] += 1
        added = clear + state["emitted"]  # the decoder's entry after this code
        if code != clear and state["emitted"] >= 2 and added < 4096 and \
                added == (1 << state["width"]) - 1 and state["width"] < 12:
            state["width"] += 1

    def reset():
        emit(clear)
        state.update(width=code_size + 1, emitted=0)
        return {}, clear + 2

    table, nxt = reset()
    flat = [int(v) for v in np.asarray(indices).ravel()]
    w = flat[0] if flat else None
    for b in flat[1:]:
        c = table.get((w, b))
        if c is not None:
            w = c
            continue
        emit(w)
        if nxt < 4096:
            table[(w, b)] = nxt
            nxt += 1
        else:
            table, nxt = reset()
        w = b
    if w is not None:
        emit(w)
    if end_code:
        put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def gif_palette_bytes(palette) -> tuple[bytes, int]:
    """An (N, 3) palette padded with black to a power of two ≥ 2: its
    bytes and the 3-bit size field."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    pal = np.concatenate([pal, np.zeros((2 ** bits - len(pal), 3), np.uint8)])
    return pal.tobytes(), bits - 1


def encode_gif(indices, screen=None, offset=(0, 0), palette=None, local_palette=None,
               transparency=None, interlace: bool = False, code_size=None,
               end_code: bool = True, end_after=None, cut=None, extensions=(), frames=(),
               version: bytes = b"GIF89a", stray: bytes = b"") -> bytes:
    """A GIF whose frame 0 holds the (h, w) palette ``indices`` at
    ``offset`` on a screen of ``screen`` (w, h) (default: the frame's
    extent), with a global ``palette`` and/or a ``local_palette`` ((N, 3)
    each, or None), a graphic control extension when ``transparency`` is
    an index, rows in the four-pass order when ``interlace``, the initial
    LZW ``code_size`` (default: the smallest that holds the indices, at
    least 2), no End code unless ``end_code``, an early End code after
    ``end_after`` codes (:func:`gif_lzw`), the file cut after ``cut``
    bytes of frame 0's sub-blocks (no trailer) when given; ``extensions``
    ((label, payload) pairs) and ``stray`` bytes come before frame 0, and
    ``frames`` ((indices, offset) pairs) after it."""
    idx = np.asarray(indices)
    h, w = idx.shape
    x0, y0 = offset
    sw, sh = screen if screen is not None else (x0 + w, y0 + h)
    if code_size is None:
        code_size = max(2, int(idx.max()).bit_length() if idx.size else 2)
    out = bytearray(version + struct.pack("<HH", sw, sh))
    if palette is not None:
        pal, bits = gif_palette_bytes(palette)
        out += bytes([0x80 | 0x70 | bits, 0, 0]) + pal
    else:
        out += bytes([0x70, 0, 0])
    for label, payload in extensions:  # a payload, or a list of sub-blocks
        blocks = payload if isinstance(payload, list) else [payload]
        out += b"!" + bytes([label]) + b"".join(sub_blocks(p)[:-1] for p in blocks) + b"\0"
    out += stray
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1]) + struct.pack("<H", 0) + bytes([transparency, 0])

    def image(idx, x0, y0, lp, il, ea=None):
        h, w = idx.shape
        flags = 0x40 if il else 0
        lpb = b""
        if lp is not None:
            lpb, bits = gif_palette_bytes(lp)
            flags |= 0x80 | bits
        rows = idx
        if il:
            order = [r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                     for r in range(start, h, step)]
            rows = idx[order]
        return (b"," + struct.pack("<HHHH", x0, y0, w, h) + bytes([flags]) + lpb
                + bytes([code_size]), gif_lzw(rows, code_size, end_code, ea))

    head, lzw_bytes = image(idx, x0, y0, local_palette, interlace, end_after)
    body = sub_blocks(lzw_bytes)
    if cut is not None:
        return bytes(out + head + body[:cut])
    out += head + body
    for f_idx, (fx, fy) in frames:
        h2, data = image(np.asarray(f_idx), fx, fy, None, False)
        out += h2 + sub_blocks(data)
    return bytes(out + b";")


# ------------------------------------------------------------------ WebP
def riff_chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff_webp(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def webp_chunks(data: bytes) -> list:
    """(tag, payload) of each chunk of a WebP file after its RIFF header."""
    out, p = [], 12
    while p + 8 <= len(data):
        tag, n = data[p:p + 4], struct.unpack("<I", data[p + 4:p + 8])[0]
        out.append((tag, data[p + 8:p + 8 + n]))
        p += 8 + n + (n & 1)
    return out


def webp_animation(canvas, frames, flags: int = 0x02, background: int = 0) -> bytes:
    """An animated WebP of ``canvas`` (w, h) whose ``frames`` are (still
    WebP file, x, y) triples: each file's ALPH / VP8 / VP8L chunks in an
    ANMF at the (even) offset, no blending, no disposal."""
    w, h = canvas
    body = riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + struct.pack("<I", w - 1)[:3]
                      + struct.pack("<I", h - 1)[:3])
    body += riff_chunk(b"ANIM", struct.pack("<IH", background, 0))
    for data, x, y in frames:
        inner = [(t, p) for t, p in webp_chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L")]
        with_size = [p for t, p in inner if t != b"ALPH"][0]
        fw, fh = webp_size(with_size, inner[-1][0])
        hdr = b"".join(struct.pack("<I", v)[:3] for v in (x // 2, y // 2, fw - 1, fh - 1, 100))
        body += riff_chunk(b"ANMF", hdr + bytes([0x02]) + b"".join(riff_chunk(t, p) for t, p in inner))
    return riff_webp(body)


def webp_size(payload: bytes, tag: bytes) -> tuple[int, int]:
    if tag == b"VP8L":
        v = int.from_bytes(payload[1:5], "little")
        return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
    return (int.from_bytes(payload[6:8], "little") & 0x3FFF,
            int.from_bytes(payload[8:10], "little") & 0x3FFF)


def _reverse_bits(code, length):
    code, length = np.asarray(code, np.int64), np.asarray(length, np.int64)
    out = np.zeros_like(code)
    for i in range(15):
        out |= ((code >> i) & 1) << np.maximum(length - 1 - i, 0) * (i < length)
    return np.where(length > 0, out, 0)


class _Bits:
    """LSB-first bit packing (VP8L's order) of (value, bits) fields,
    packed at the end with numpy."""

    def __init__(self):
        self.values, self.bits = [], []

    def put(self, value: int, bits: int):
        self.put_many(np.array([value]), np.array([bits]))

    def code(self, code: int, length: int):  # a prefix code, its first bit its MSB
        self.put(int(_reverse_bits(code, length)), length)

    def put_many(self, values, bits):
        self.values.append(np.asarray(values, np.int64) & ((1 << np.asarray(bits, np.int64)) - 1))
        self.bits.append(np.asarray(bits, np.int64))

    def bytes(self) -> bytes:
        v, n = np.concatenate(self.values), np.concatenate(self.bits)
        start = np.repeat(np.cumsum(n) - n, n)
        j = np.arange(int(n.sum())) - start
        bit = (np.repeat(v, n) >> j) & 1
        return np.packbits(bit.astype(np.uint8), bitorder="little").tobytes()


def huffman_lengths(freq, limit: int) -> list:
    """Huffman code lengths of ``freq`` no longer than ``limit`` (the
    counts halved until they fit); an alphabet of one used symbol gets
    length 1 for it alone."""
    import heapq

    freq = [int(f) for f in freq]
    while True:
        used = [i for i, f in enumerate(freq) if f > 0]
        lengths = [0] * len(freq)
        if len(used) <= 1:
            for i in used:
                lengths[i] = 1
            return lengths
        heap = [(freq[i], k, [i]) for k, i in enumerate(used)]
        heapq.heapify(heap)
        k = len(heap)
        while len(heap) > 1:
            f1, _, s1 = heapq.heappop(heap)
            f2, _, s2 = heapq.heappop(heap)
            for i in s1 + s2:
                lengths[i] += 1
            heapq.heappush(heap, (f1 + f2, k, s1 + s2))
            k += 1
        if max(lengths) <= limit:
            return lengths
        freq = [(f + 1) >> 1 if f else 0 for f in freq]


def canonical(lengths) -> list:
    """Canonical prefix codes of ``lengths``, by (length, symbol)."""
    codes, code = [0] * len(lengths), 0
    for ln in range(1, 16):
        for s, L in enumerate(lengths):
            if L == ln:
                codes[s] = code
                code += 1
        code <<= 1
    return codes


_VP8L_CL_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _vp8l_code(bw: _Bits, lengths):
    """A normal (length-coded) VP8L prefix code of ``lengths``."""
    cl = huffman_lengths(np.bincount(lengths, minlength=19), 7)
    if sum(1 for v in cl if v) == 1:  # one code length used: a two-entry code
        cl[next(i for i, v in enumerate(cl) if v == 0 and i != lengths[0])] = 1
    clc = canonical(cl)
    bw.put(0, 1)
    bw.put(19 - 4, 4)
    for s in _VP8L_CL_ORDER:
        bw.put(cl[s], 3)
    bw.put(0, 1)  # max_symbol = the alphabet
    for L in lengths:
        bw.code(clc[L], cl[L])


def encode_vp8l_gray(gray) -> bytes:
    """A lossless WebP of 8-bit gray pixels: the subtract-green transform
    (red and blue become 0), one Huffman group, green coded with Huffman
    lengths from its histogram, red, blue, alpha and distance single-symbol
    codes; no LZ77, no colour cache. numpy only."""
    g = np.asarray(gray, np.uint8)
    H, W = g.shape
    bw = _Bits()
    bw.put(0x2F, 8)
    bw.put(W - 1, 14)
    bw.put(H - 1, 14)
    bw.put(0, 1)
    bw.put(0, 3)
    bw.put(1, 1)
    bw.put(2, 2)  # subtract green
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta prefix codes
    freq = np.bincount(g.ravel(), minlength=256)
    lengths = huffman_lengths(list(freq) + [0] * 24, 15)
    if sum(1 for v in lengths if v) == 1:  # a flat image: a simple one-symbol code
        bw.put(1, 1), bw.put(0, 1), bw.put(1, 1), bw.put(int(g.flat[0]), 8)
        codes = lengths = [0] * 280
    else:
        _vp8l_code(bw, lengths)
        codes = canonical(lengths)
    for symbol in (0, 0, 255, 0):  # red, blue, alpha, distance
        bw.put(1, 1), bw.put(0, 1), bw.put(1, 1), bw.put(symbol, 8)
    rev = _reverse_bits(codes[:256], lengths[:256])
    bw.put_many(rev[g.ravel()], np.asarray(lengths[:256])[g.ravel()])
    return riff_webp(riff_chunk(b"VP8L", bw.bytes()))


def libwebp():
    """Pillow's bundled libwebp through ctypes (its encoder's every
    option), or None where this Pillow bundles none."""
    import ctypes
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = {k: glob.glob(os.path.join(libs, f"lib{k}-*.so*")) for k in ("sharpyuv", "webp")}
    if not found["webp"]:
        return None
    for path in found["sharpyuv"]:
        ctypes.CDLL(path, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(found["webp"][0])


def libwebp_encode(lib, rgb, **config) -> bytes:
    """A WebP of (H, W, 3) RGB or (H, W, 4) RGBA ``rgb`` through libwebp's
    WebPEncode with the WebPConfig fields given (e.g. filter_type 0 for the
    simple filter, filter_sharpness, partitions (which libwebp honours at
    method ≤ 2 or with low_memory), segments, filter_strength,
    alpha_compression 0 for raw alpha, alpha_filtering)."""
    import ctypes

    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fields = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
              "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
              "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
              "show_compressed", "preprocessing", "partitions", "partition_limit",
              "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
              "use_delta_palette", "use_sharp_yuv", "qmin", "qmax"]

    class Config(ctypes.Structure):
        _fields_ = [(f, c_float if f in ("quality", "target_PSNR") else c_int) for f in fields]

    class Picture(ctypes.Structure):
        _fields_ = [("use_argb", c_int), ("colorspace", c_int), ("width", c_int),
                    ("height", c_int), ("y", c_ptr), ("u", c_ptr), ("v", c_ptr),
                    ("y_stride", c_int), ("uv_stride", c_int), ("a", c_ptr), ("a_stride", c_int),
                    ("pad1", ctypes.c_uint32 * 2), ("argb", c_ptr), ("argb_stride", c_int),
                    ("pad2", ctypes.c_uint32 * 3), ("writer", c_ptr), ("custom_ptr", c_ptr),
                    ("extra_info_type", c_int), ("extra_info", c_ptr), ("stats", c_ptr),
                    ("error_code", c_int), ("progress_hook", c_ptr), ("user_data", c_ptr),
                    ("pad3", ctypes.c_uint32 * 3), ("pad4", c_ptr), ("pad5", c_ptr),
                    ("pad6", ctypes.c_uint32 * 8), ("memory_", c_ptr), ("memory_argb_", c_ptr),
                    ("pad7", c_ptr * 2)]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", c_ptr), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32)]

    abi = 0x020F
    cfg, pic, out = Config(), Picture(), Writer()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, c_float(75.0), abi)
    for k, v in config.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), config
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    pic.height, pic.width = rgb.shape[:2]
    channels = rgb.shape[2]
    importer = lib.WebPPictureImportRGBA if channels == 4 else lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), rgb.ctypes.data_as(c_ptr), rgb.shape[1] * channels)
    lib.WebPMemoryWriterInit(ctypes.byref(out))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, c_ptr).value
    pic.custom_ptr = ctypes.addressof(out)
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), pic.error_code
        return ctypes.string_at(out.mem, out.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(out))


def small_files(seed: int) -> dict:
    """name → (bytes, kind) of every small fixture."""
    from PIL import Image

    H, W = H_SMALL, W_SMALL
    g = scene(H, W, seed)
    rgb = scene(H, W, seed + 1, 3)
    cmyk = scene(H, W, seed + 2, 4)
    files = {}

    def pil(name, kind, im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        files[name] = (buf.getvalue(), kind)

    # PIL's own writer
    pil("prog_gray.jpg", "progressive gray (PIL)", Image.fromarray(g), progressive=True,
        quality=80)
    pil("prog_420.jpg", "progressive YCbCr 4:2:0 (PIL)", Image.fromarray(rgb), progressive=True,
        quality=80, subsampling=2)
    pil("prog_444.jpg", "progressive YCbCr 4:4:4 (PIL)", Image.fromarray(rgb), progressive=True,
        quality=90, subsampling=0)
    pil("cmyk.jpg", "CMYK baseline (PIL, Adobe transform 0)", Image.fromarray(cmyk, "CMYK"),
        quality=85)
    pil("cmyk_prog.jpg", "CMYK progressive (PIL)", Image.fromarray(cmyk, "CMYK"),
        quality=85, progressive=True)
    pil("rgb_pil.jpg", "RGB baseline (PIL keep_rgb: ids R G B, Adobe transform 0)",
        Image.fromarray(rgb), quality=85, keep_rgb=True)
    data = io.BytesIO()
    Image.fromarray(rgb).save(data, "JPEG", quality=80)
    files["baseline_no_dht.jpg"] = (strip_dht(data.getvalue()),
                                    "baseline YCbCr without DHT (motion JPEG: standard tables)")
    # this file's encoder
    rgbp = [rgb[..., i] for i in range(3)]
    ycc = list(np.moveaxis(_rgb_to_ycc(rgb), -1, 0))
    enc = {
        "prog_restart.jpg": ("progressive YCbCr 4:2:0 with restarts (DRI 3)",
                             dict(planes=ycc, sampling=[(2, 2), (1, 1), (1, 1)],
                                  mode="progressive", restart=3)),
        "prog_partial.jpg": ("progressive stopped short of full refinement (block smoothing)",
                             dict(planes=[g], mode="progressive",
                                  scans=[([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2),
                                         ([0], 6, 20, 0, 1), ([0], 1, 5, 2, 1)])),
        "prog_partial_420.jpg": ("progressive 4:2:0, AC never sent (block smoothing with DC)",
                                 dict(planes=ycc, sampling=[(2, 2), (1, 1), (1, 1)],
                                      mode="progressive",
                                      scans=[([0, 1, 2], 0, 0, 0, 0), ([0], 1, 9, 0, 3)])),
        "arith_seq.jpg": ("arithmetic sequential YCbCr 4:2:0 (SOF9)",
                          dict(planes=ycc, sampling=[(2, 2), (1, 1), (1, 1)], arith=True)),
        "arith_seq_restart.jpg": ("arithmetic sequential gray, restarts and DAC (SOF9)",
                                  dict(planes=[g], arith=True, restart=5,
                                       dac={"dc": (1, 4), "k": 3})),
        "arith_prog.jpg": ("arithmetic progressive YCbCr 4:2:0 (SOF10)",
                           dict(planes=ycc, sampling=[(2, 2), (1, 1), (1, 1)], arith=True,
                                mode="progressive")),
        "lossless_gray_p1.jpg": ("lossless gray, predictor 1 (SOF3)",
                                 dict(planes=[g], mode="lossless", predictor=1)),
        "lossless_gray_p7.jpg": ("lossless gray, predictor 7, point transform 2, restarts",
                                 dict(planes=[g], mode="lossless", predictor=7, pt=2,
                                      restart=2 * W)),
        "lossless_rgb_p1.jpg": ("lossless 3-component RGB, predictor 1 (SOF3)",
                                dict(planes=rgbp, mode="lossless", predictor=1, markers=b"")),
        "lossless_rgb_p7.jpg": ("lossless 3-component RGB, predictor 7 (SOF3)",
                                dict(planes=rgbp, mode="lossless", predictor=7, markers=b"")),
        "ycck.jpg": ("YCCK (Adobe transform 2)",
                     dict(planes=list(np.moveaxis(_cmyk_to_ycck(cmyk), -1, 0)),
                          markers=adobe(2))),
        "rgb_adobe.jpg": ("RGB (Adobe transform 0, ids 1 2 3)",
                          dict(planes=rgbp, markers=adobe(0))),
        "rgb_ids.jpg": ("RGB (ids R G B, no marker)",
                        dict(planes=rgbp, ids=[82, 71, 66], markers=b"")),
        "ycc_411.jpg": ("YCbCr 4:1:1 (h = 4)",
                        dict(planes=ycc, sampling=[(4, 1), (1, 1), (1, 1)])),
        "jpeg_12bit.jpg": ("12-bit sequential (PIL refuses)",
                           dict(planes=[g.astype(np.int64) * 16], precision=12,
                                qtables={0: quant_table(75) * 16})),
        "jpeg_hierarchical.jpg": ("hierarchical (DHP, SOF5; PIL refuses)",
                                  dict(planes=[g], sof_marker=0xC5,
                                       prefix=segment(0xDE, struct.pack(">BHHB", 8, H, W, 1)
                                                      + bytes([1, 0x11, 0])))),
        "jpeg_dnl.jpg": ("height from a DNL marker (PIL refuses)", dict(planes=[g], dnl=True)),
        "jpeg_fractional_sampling.jpg": ("fractional sampling 3:2:1 (PIL refuses)",
                                         dict(planes=ycc, sampling=[(3, 1), (2, 1), (1, 1)])),
    }
    for name, (kind, kw) in enc.items():
        files[name] = (encode_jpeg(**kw), kind)
    # netpbm
    rng = np.random.default_rng(seed + 7)
    for maxval in (1, 15, 100, 254, 256, 1023, 65535):
        img = np.minimum(np.round(g.astype(np.float64) / 255 * maxval), maxval).astype(np.int64)
        if maxval > 255:  # values around the clip at 255 as well
            img[: H // 2] = rng.integers(0, min(maxval, 600) + 1, (H // 2, W))
        files[f"p5_max{maxval}.pgm"] = (encode_pnm("P5", img, maxval),
                                        f"P5 binary graymap, maxval {maxval}")
    files["p2.pgm"] = (encode_pnm("P2", np.round(g / 255 * 1000).astype(np.int64), 1000,
                                  comment=b"plain graymap"), "P2 plain graymap, maxval 1000")
    files["p2_max15.pgm"] = (encode_pnm("P2", g >> 4, 15, comment=b"maxval 15"),
                             "P2 plain graymap, maxval 15")
    files["p6.ppm"] = (encode_pnm("P6", rgb, 255), "P6 binary pixmap")
    files["p6_max1000.ppm"] = (encode_pnm("P6", np.round(rgb / 255 * 1000).astype(np.int64),
                                          1000), "P6 binary pixmap, maxval 1000")
    files["p3.ppm"] = (encode_pnm("P3", rgb >> 2, 63, comment=b"plain pixmap"),
                       "P3 plain pixmap, maxval 63")
    bits = (g > 128).astype(np.int64)
    files["p4.pbm"] = (encode_pnm("P4", bits[:, :61]), "P4 binary bitmap (61 columns)")
    files["p1.pbm"] = (encode_pnm("P1", bits), "P1 plain bitmap")
    files.update(tiff_bmp_pfm_files(seed))
    files.update(tiff_codec_files(seed))
    files.update(tiff_compression_files(seed))
    files.update(gif_webp_files(seed))
    files.update(unported_files(seed))
    files.update(raster_files(seed))
    files.update(container_files(seed))
    files.update(layout_files(seed))
    return files


def _pil_save(im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def tiff_bmp_pfm_files(seed: int) -> dict:
    """name → (bytes, kind[, manifest extras]) of the TIFF, BMP and PFM
    fixtures: PIL's writer where it writes the kind, this file's encoders
    for the rest; the kinds PIL refuses carry their refusal word."""
    from PIL import Image

    H, W = H_SMALL, W_SMALL
    g = scene(H, W, seed + 20)
    rgb = scene(H, W, seed + 21, 3)
    cmyk = scene(H, W, seed + 22, 4)
    h2, w2 = H // 2, W // 2  # the heavier kinds at a quarter of the pixels
    g2, rgb2 = g[:h2, :w2], rgb[:h2, :w2]
    rng = np.random.default_rng(seed + 23)
    g16 = g.astype(np.int64) * 3 + rng.integers(0, 200, (H, W))  # past 255: the clip
    f32 = (g.astype(np.float32) * 1.3 - 20.5)
    f32[::7, ::5] = np.nan
    pal16 = rng.integers(0, 65536, (16, 3))
    refused = lambda word: {"refused": True, "refusal": word}  # noqa: E731
    unported = lambda word: {"refused": True, "refusal": word, "pil_reads": True}  # noqa: E731
    files = {
        # TIFF: PIL's writer
        "tiff_raw_gray.tif": (_pil_save(Image.fromarray(g), "TIFF"),
                              "TIFF 8-bit gray, uncompressed (PIL)"),
        "tiff_packbits_gray.tif": (_pil_save(Image.fromarray(g), "TIFF", compression="packbits"),
                                   "TIFF 8-bit gray, PackBits (PIL)"),
        "tiff_lzw_rgb.tif": (_pil_save(Image.fromarray(rgb2), "TIFF", compression="tiff_lzw"),
                             "TIFF RGB, LZW (PIL)"),
        "tiff_deflate_rgba.tif": (_pil_save(Image.fromarray(np.dstack([rgb2, g2])), "TIFF",
                                            compression="tiff_adobe_deflate"),
                                  "TIFF RGBA, Deflate (PIL)"),
        # TIFF: this file's encoder
        "tiff_lzw_pred2_16bit.tif": (encode_tiff(g16, bits=16, compression=5, predictor=2,
                                                 rows_per_strip=8),
                                     "TIFF 16-bit gray, LZW, horizontal predictor, 8-row strips"),
        "tiff_be_16bit_tiles.tif": (encode_tiff(g16, bits=16, compression=32946, order=">",
                                                tile=(16, 32)),
                                    "TIFF 16-bit gray, big-endian, 16×32 tiles, Deflate"),
        "tiff_planar_rgb16.tif": (encode_tiff(rgb2.astype(np.int64) * 257, bits=16,
                                              photometric=2, compression=5, planar=2,
                                              predictor=2, rows_per_strip=5),
                                  "TIFF RGB 16-bit, separate planes, LZW, predictor 2"),
        "tiff_float_pred3.tif": (encode_tiff(f32, bits=32, sample_format=3, compression=8,
                                             predictor=3, rows_per_strip=16),
                                 "TIFF 32-bit float with NaNs, Deflate, floating-point "
                                 "predictor"),
        "tiff_bigtiff_lzw.tif": (encode_tiff(g, compression=5, bigtiff=True, rows_per_strip=12),
                                 "BigTIFF 8-bit gray, LZW"),
        "tiff_fill2_bilevel.tif": (encode_tiff(g > 128, bits=1, fill_order=2),
                                   "TIFF bilevel, fill order 2, uncompressed"),
        "tiff_fill2_lzw_gray.tif": (encode_tiff(g, compression=5, fill_order=2),
                                    "TIFF 8-bit gray, fill order 2, LZW"),
        "tiff_palette4.tif": (encode_tiff(g >> 4, bits=4, photometric=3, colormap=pal16,
                                          compression=32773, rows_per_strip=10),
                              "TIFF 4-bit palette, PackBits"),
        "tiff_2bit_miniswhite.tif": (encode_tiff(g >> 6, bits=2, photometric=0),
                                     "TIFF 2-bit gray, min-is-white, uncompressed"),
        "tiff_12bit.tif": (encode_tiff(g16 * 4 % 4096, bits=12, rows_per_strip=7),
                           "TIFF 12-bit gray, uncompressed"),
        "tiff_s16_be_lzw.tif": (encode_tiff(g16 - 300, bits=16, sample_format=2,
                                            compression=5, order=">"),
                                "TIFF signed 16-bit, big-endian, LZW (PIL reads libtiff's "
                                "swapped samples swapped)"),
        "tiff_i32_raw.tif": (encode_tiff(g16[:h2, :w2] * 70000 - 5000, bits=32,
                                         sample_format=2),
                             "TIFF signed 32-bit, uncompressed"),
        "tiff_cmyk16_be.tif": (encode_tiff(cmyk[:h2, :w2].astype(np.int64) * 257, bits=16,
                                           photometric=5, order=">"),
                               "TIFF CMYK 16-bit, big-endian, uncompressed"),
        "tiff_ycbcr_raw.tif": (encode_tiff(rgb2, photometric=6, pad=h2 * w2),
                               "TIFF YCbCr, uncompressed (PIL reads 4 bytes per pixel)"),
        "tiff_rgba_assoc_planar.tif": (encode_tiff(np.dstack([rgb2, g2]), photometric=2,
                                                   extra=(1,), compression=8, planar=2,
                                                   tile=(16, 16)),
                                       "TIFF RGBA premultiplied, separate planes, tiles, "
                                       "Deflate"),
        # Orientation: PIL flips or rotates the decoded image (non-square, so
        # a swap of width and height shows)
        "tiff_orient2.tif": (encode_tiff(g2, orientation=2), "TIFF Orientation 2, uncompressed"),
        "tiff_orient3.tif": (encode_tiff(g2, compression=5, orientation=3),
                             "TIFF Orientation 3, LZW"),
        "tiff_orient4.tif": (encode_tiff(rgb2, photometric=2, compression=8, tile=(16, 16),
                                         orientation=4),
                             "TIFF Orientation 4, RGB, Deflate tiles"),
        "tiff_orient5.tif": (encode_tiff(g2, rows_per_strip=5, orientation=5),
                             "TIFF Orientation 5, uncompressed strips"),
        "tiff_orient6.tif": (encode_tiff(g16[:h2, :w2], bits=16, compression=5, predictor=2,
                                         orientation=6),
                             "TIFF Orientation 6, 16-bit, LZW, predictor 2"),
        "tiff_orient7.tif": (encode_tiff(g2, compression=32773, order=">", orientation=7),
                             "TIFF Orientation 7, big-endian, PackBits"),
        "tiff_orient8.tif": (encode_tiff(rgb2, photometric=2, planar=2, orientation=8),
                             "TIFF Orientation 8, RGB, separate planes, uncompressed"),
        "tiff_xmp_orient6.tif": (encode_tiff(g2, tags=[(700, 1, list(
            b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'))]),
            "TIFF with no Orientation tag, XMP tiff:Orientation 6"),
        "tiff_la_packbits.tif": (encode_tiff(np.dstack([g, 255 - g]), extra=(2,),
                                             compression=32773),
                                 "TIFF gray + alpha, PackBits"),
        # TIFF kinds PIL refuses
        "tiff_float64.tif": (encode_tiff(f32[:h2, :w2].astype(np.float64), bits=64,
                                         sample_format=3),
                             "TIFF 64-bit float (PIL: unknown pixel mode)",
                             refused("unknown pixel mode")),
        "tiff_lab.tif": (encode_tiff(rgb2, photometric=8),
                         "TIFF CIELAB (PIL cannot convert LAB to L)", refused("CIELAB")),
        # TIFF kinds PIL reads through libtiff
        "tiff_jpeg.tif": (_pil_save(Image.fromarray(rgb2), "TIFF", compression="jpeg"),
                          "TIFF RGB, new-style JPEG (PIL, libtiff)"),
        "tiff_ccitt_g4.tif": (_pil_save(Image.fromarray(g > 128), "TIFF", compression="group4"),
                              "TIFF CCITT Group 4 (PIL, libtiff)"),
        "tiff_lzma.tif": (_pil_save(Image.fromarray(g2), "TIFF", compression="lzma"),
                          "TIFF LZMA (PIL, libtiff)"),
        "tiff_zstd.tif": (_pil_save(Image.fromarray(g2), "TIFF", compression="zstd"),
                          "TIFF ZSTD (PIL, libtiff)"),
        "tiff_ycbcr_lzw.tif": (encode_tiff(rgb2, photometric=6, compression=5),
                               "TIFF YCbCr, LZW, no subsampling tag (libtiff's RGBA interface "
                               "reads the chunky samples as 2 × 2 blocks)"),
        # BMP: PIL's writer
        "bmp_1bit.bmp": (_pil_save(Image.fromarray(g > 128), "BMP"), "BMP 1-bit (PIL)"),
        "bmp_gray8.bmp": (_pil_save(Image.fromarray(g), "BMP"), "BMP 8-bit grey palette (PIL)"),
        "bmp_pal8.bmp": (_pil_save(Image.fromarray(rgb).quantize(40), "BMP"),
                         "BMP 8-bit colour palette (PIL)"),
        "bmp_rgb24.bmp": (_pil_save(Image.fromarray(rgb2), "BMP"), "BMP 24-bit (PIL)"),
        "bmp_rgba32.bmp": (_pil_save(Image.fromarray(np.dstack([rgb2, g2])), "BMP"),
                           "BMP 32-bit BGRA (PIL)"),
    }
    # BMP: this file's encoder
    pal = rng.integers(0, 256, (16, 3))
    idx4 = (g >> 4).astype(np.int64)
    rows8 = (g >> 2)[::-1]
    files["bmp_rle8.bmp"] = (encode_bmp(g >> 2, 8, compression=1,
                                        palette=np.stack([np.arange(64) * 4] * 3, 1)[:, ::-1] ^ 7,
                                        rle=rle_encode(rows8, False, delta_at=(5, 3, 1))),
                             "BMP RLE8 with a delta (PIL's reading of it)")
    files["bmp_rle4.bmp"] = (encode_bmp(idx4, 4, compression=2, palette=pal,
                                        rle=rle_encode(idx4[::-1], True)),
                             "BMP RLE4")
    w565 = (rng.integers(0, 65536, (h2, w2))).astype(np.int64)
    w565[0, :4] = (0xF800, 0x07E0, 0x001F, 0xFFFF)
    files["bmp_565.bmp"] = (encode_bmp(w565, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
                            "BMP 16-bit 5-6-5 BITFIELDS")
    files["bmp_555.bmp"] = (encode_bmp(w565, 16), "BMP 16-bit 5-5-5")
    files["bmp_os2_8bit.bmp"] = (encode_bmp(g >> 3, 8, header=12,
                                            palette=rng.integers(0, 256, (32, 3))),
                                 "BMP OS/2 1.x header, 8-bit palette")
    files["bmp_topdown_24.bmp"] = (encode_bmp(rgb2, 24, header=124, top_down=True),
                                   "BMP v5 header, 24-bit, top-down rows")
    files["bmp_v4_abgr32.bmp"] = (encode_bmp(np.dstack([rgb2, g2]), 32, header=108,
                                             compression=3,
                                             masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
                                  "BMP v4 header, 32-bit ABGR BITFIELDS")
    files["bmp_4bit.bmp"] = (encode_bmp(idx4, 4, palette=pal), "BMP 4-bit palette")
    # BMP kinds PIL refuses
    files["bmp_2bit.bmp"] = (encode_bmp(g >> 6, 2, palette=pal[:4]),
                             "BMP 2-bit (PIL: unsupported depth)", refused("pixel depth"))
    files["bmp_jpeg.bmp"] = (encode_bmp(rgb2, 24, compression=4),
                             "BMP with JPEG compression (PIL refuses)", refused("compression"))
    files["bmp_bitfields.bmp"] = (encode_bmp(w565, 16, compression=3,
                                             masks=(0xF000, 0x7E0, 0x1F)),
                                  "BMP 16-bit with masks PIL does not map",
                                  refused("bitfields"))
    files["bmp_header20.bmp"] = (b"BM" + struct.pack("<IHHI", 0, 0, 0, 34)
                                 + struct.pack("<IHHHHHHHH", 20, w2, h2, 1, 24, 0, 0, 0, 0)
                                 + bytes(w2 * h2 * 3 + h2 * 4),
                                 "BMP with a 20-byte header (PIL refuses)", refused("header"))
    files["bmp_palette300.bmp"] = (encode_bmp(g, 8, palette=rng.integers(0, 256, (300, 3))),
                                   "BMP with 300 palette entries (PIL refuses)",
                                   refused("palette"))
    files["bmp_rle8_bilevel.bmp"] = (encode_bmp(g > 128, 8, compression=1,
                                                palette=[[0, 0, 0], [255, 255, 255]],
                                                rle=rle_encode((g > 128)[::-1], False)),
                                     "BMP RLE8 with a black-and-white palette (PIL refuses)",
                                     refused("RLE"))
    # PFM
    files["pfm_le.pfm"] = (encode_pfm(f32, -1.0), "PFM gray, little-endian")
    files["pfm_be.pfm"] = (encode_pfm(f32[:h2, :w2] * 2, 0.5), "PFM gray, big-endian")
    return files


def tiff_codec_files(seed: int) -> dict:
    """name → (bytes, kind[, manifest extras]) of the TIFFs PIL reads
    through libtiff's JPEG, old-style JPEG, CCITT and YCbCr paths: PIL's
    writer where it writes the kind, this file's encoders for the rest, the
    recovery of libtiff's fax decoder from bad data, and the layouts the
    port refuses though PIL reads them."""
    from PIL import Image

    H, W = H_SMALL, W_SMALL
    rgb = scene(H, W, seed + 40, 3)
    ycc = rgb_to_ycbcr(rgb)
    g = rgb[..., 1]
    bits = (scene(H, W - 3, seed + 41) > 120).astype(np.int64)  # an odd width
    unported = lambda word: {"refused": True, "refusal": word, "pil_reads": True}  # noqa: E731

    def dither(img):
        return Image.fromarray(img).convert("1")


    def second_strip(change):
        seen = []

        def corrupt(data):
            seen.append(1)
            return change(data) if len(seen) == 2 else data
        return corrupt

    def bad_code(data):  # zeros where a run's code starts: no white code begins so
        return data[:6] + b"\x00\x80" + data[8:]

    def tall_last(blk):  # every strip's stream 16 rows tall, the last one too
        full = np.pad(blk, ((0, 16 - blk.shape[0]), (0, 0), (0, 0)), mode="edge")
        return encode_jpeg([full[..., i] for i in range(3)], sampling=[(2, 2), (1, 1), (1, 1)],
                           markers=b"")

    def short(blk):  # each strip's stream 2 rows short
        return encode_jpeg([blk[:-2, :, i] for i in range(3)], sampling=[(2, 2), (1, 1), (1, 1)],
                           markers=b"")

    def no_tag(blk):  # YCbCrSubsampling absent: libtiff takes the stream's 1 × 1
        return encode_jpeg([blk[..., i] for i in range(3)], markers=b"")

    def jpeg12(blk):
        return encode_jpeg([blk[..., 0]], precision=12, markers=b"")

    return {
        # new-style JPEG (7)
        "tiff_jpeg_gray.tif": (_pil_save(Image.fromarray(g), "TIFF", compression="jpeg"),
                               "TIFF gray, new-style JPEG (PIL, libtiff)"),
        "tiff_jpeg_ycbcr_pil.tif": (_pil_save(Image.fromarray(rgb).convert("YCbCr"), "TIFF",
                                              compression="jpeg"),
                                    "TIFF YCbCr 1 × 1, new-style JPEG (PIL, libtiff)"),
        "tiff_jpeg_ycc420.tif": (encode_tiff_jpeg(ycc, 6, (2, 2), "all", rows_per_strip=16),
                                 "TIFF YCbCr 4:2:0, new-style JPEG, 16-row strips, shared "
                                 "JPEGTables (quantization and Huffman)"),
        "tiff_jpeg_ycc422_tiles.tif": (encode_tiff_jpeg(ycc, 6, (2, 1), "dqt", restart=2,
                                                        tile=(32, 16), order=">"),
                                       "TIFF YCbCr 4:2:2, new-style JPEG, 32×16 tiles, "
                                       "restart intervals, big-endian"),
        "tiff_jpeg_rgb_planar.tif": (encode_tiff_jpeg(rgb, 2, tables="dqt", planar=2,
                                                      rows_per_strip=24),
                                     "TIFF RGB, new-style JPEG, separate planes"),
        "tiff_jpeg_ycc_planar.tif": (encode_tiff_jpeg(ycc, 6, (1, 1), "none", planar=2,
                                                      rows_per_strip=16,
                                                      tags=[(530, 3, [1, 1])]),
                                     "TIFF YCbCr, new-style JPEG, separate planes (libtiff's "
                                     "RGBA interface)"),
        "tiff_jpeg_orient6.tif": (encode_tiff_jpeg(ycc[:32, :40], 6, (2, 2), "all",
                                                   rows_per_strip=16, orientation=6),
                                  "TIFF YCbCr 4:2:0, new-style JPEG, Orientation 6"),
        "tiff_jpeg_tall_last.tif": (encode_tiff(ycc, photometric=6, compression=7,
                                                codec=tall_last, rows_per_strip=16,
                                                tags=[(530, 3, [2, 2])]),
                                    "TIFF new-style JPEG whose last strip's stream is a whole "
                                    "strip tall"),
        "tiff_jpeg_no_subsampling_tag.tif": (encode_tiff(ycc, photometric=6, compression=7,
                                                         codec=no_tag, rows_per_strip=24),
                                             "TIFF YCbCr new-style JPEG 1 × 1 without "
                                             "YCbCrSubsampling (libtiff's fix-up)"),
        # YCbCr through TIFFRGBAImage
        "tiff_ycbcr_22_deflate.tif": (encode_tiff_ycbcr(ycc, 2, 2, 8, rows_per_strip=8),
                                      "TIFF YCbCr 2 × 2, Deflate, 8-row strips"),
        "tiff_ycbcr_41_packbits_tiles.tif": (encode_tiff_ycbcr(ycc, 4, 1, 32773,
                                                               tile=(16, 16)),
                                             "TIFF YCbCr 4 × 1, PackBits, tiles"),
        "tiff_ycbcr_44_lzw_tiles.tif": (encode_tiff_ycbcr(ycc[:, :40], 4, 4, 5, tile=(32, 16),
                                                          tags=[(531, 3, [2])]),
                                        "TIFF YCbCr 4 × 4, LZW, tiles cut by the right edge "
                                        "(libtiff's 10-byte skip), co-sited"),
        "tiff_ycbcr_refbw.tif": (encode_tiff_ycbcr(ycc, 2, 1, 5, predictor=2, rows_per_strip=12,
                                                   order=">",
                                                   tags=[(532, 5, [16, 1, 235, 1, 128, 1, 240, 1,
                                                                   128, 1, 240, 1]),
                                                         (529, 5, [2126, 10000, 7152, 10000,
                                                                   722, 10000])]),
                                 "TIFF YCbCr 2 × 1, LZW, predictor 2 (left undone by libtiff: "
                                 "rows of 4 × 32 bytes), ReferenceBlackWhite, Rec. 709 "
                                 "coefficients, big-endian"),
        "tiff_ycbcr_orient3.tif": (encode_tiff_ycbcr(ycc, 1, 2, 5, rows_per_strip=10,
                                                     orientation=3),
                                   "TIFF YCbCr 1 × 2, LZW, Orientation 3"),
        # old-style JPEG (6)
        "tiff_ojpeg_tables.tif": (encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16),
                                  "TIFF old-style JPEG, JPEGQ/DC/ACTables, 4:2:0, 16-row strips "
                                  "with restart intervals"),
        "tiff_ojpeg_jif.tif": (encode_tiff_ojpeg(ycc, 2, 1, layout="jif"),
                               "TIFF old-style JPEG, JPEGInterchangeFormat header, 4:2:2"),
        "tiff_ojpeg_jif_whole.tif": (encode_tiff_ojpeg(ycc, 1, 1, rows_per_strip=8,
                                                       layout="jif_whole"),
                                     "TIFF old-style JPEG, the whole stream at "
                                     "JPEGInterchangeFormat, 8-row strips"),
        # CCITT
        "tiff_ccitt_mh.tif": (_pil_save(dither(g), "TIFF", compression="tiff_ccitt"),
                              "TIFF CCITT Modified Huffman (PIL, libtiff)"),
        "tiff_ccitt_rlew.tif": (_pil_save(dither(g), "TIFF", compression="tiff_raw_16"),
                                "TIFF CCITT RLEW (PIL, libtiff; libtiff's word alignment "
                                "misreads PIL's own rows)"),
        "tiff_ccitt_g3_1d.tif": (_pil_save(dither(g), "TIFF", compression="group3"),
                                 "TIFF CCITT Group 3 1D (PIL, libtiff)"),
        "tiff_ccitt_g3_2d_fill.tif": (encode_tiff_fax(bits, 3, 1, 5, rows_per_strip=16),
                                      "TIFF CCITT Group 3 2D, fill bits, odd width"),
        "tiff_ccitt_g4_fill2.tif": (encode_tiff_fax(bits, 4, 0, fill_order=2,
                                                    rows_per_strip=20),
                                    "TIFF CCITT Group 4, fill order 2, min-is-white"),
        "tiff_ccitt_g4_tiles.tif": (encode_tiff_fax(bits, 4, 1, tile=(32, 16)),
                                    "TIFF CCITT Group 4, tiles"),
        "tiff_ccitt_mh_bad_code.tif": (encode_tiff_fax(bits, 2, 1, rows_per_strip=16,
                                                       corrupt=second_strip(bad_code)),
                                       "TIFF CCITT MH, a bad code word in the second strip "
                                       "(its row ends, the rows after it stay on it)"),
        "tiff_ccitt_g3_noeol.tif": (encode_tiff_fax(bits, 3, 1, 0, rows_per_strip=16,
                                                    corrupt=second_strip(
                                                        lambda d: d[:len(d) // 3])),
                                    "TIFF CCITT Group 3 1D, the second strip cut short "
                                    "(libtiff decodes it again without EOLs, and the rest)"),
        "tiff_ccitt_g4_eofb.tif": (encode_tiff_fax(bits, 4, 1, rows_per_strip=16,
                                                   corrupt=second_strip(
                                                       lambda d: fax_encode(bits[16:21], 4))),
                                   "TIFF CCITT Group 4, an EOFB after 5 rows of the second "
                                   "strip (its other rows keep the first strip's)"),
        # layouts PIL reads that the port refuses
        "tiff_jpeg_12bit.tif": (encode_tiff(g.astype(np.int64) * 16, bits=12, compression=7,
                                            codec=jpeg12),
                                "TIFF 12-bit gray, new-style JPEG", unported("12-bit")),
        "tiff_jpeg_short.tif": (encode_tiff(ycc, photometric=6, compression=7, codec=short,
                                            rows_per_strip=16, tags=[(530, 3, [2, 2])]),
                                "TIFF new-style JPEG whose streams are 2 rows short of their "
                                "strips", unported("smaller")),
        "tiff_ojpeg_be_strips.tif": (encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16, order=">"),
                                     "TIFF old-style JPEG, big-endian, 16-row strips",
                                     unported("big-endian")),
        "tiff_ojpeg_one_restart.tif": (encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16,
                                                         tags=[(515, 3, [1])]),
                                       "TIFF old-style JPEG whose restart interval is not a "
                                       "strip's", unported("restart interval")),
    }


def tiff_compression_files(seed: int) -> dict:
    """The fixtures of TIFF's LZMA, ZSTD and ThunderScan compressions (the
    encoders above), a TIFF that repeats tags (PIL reads the last entry of
    each, libtiff the first), and the two compressions PIL refuses: WebP
    (Pillow's libtiff is built without it) and SGILog on a photometric
    other than LogL or LogLuv."""
    import lzma

    from PIL import Image

    g = scene(24, 32, seed + 60)
    rng = np.random.default_rng(seed + 61)
    g16 = g[:16, :24].astype(np.int64) * 251 + rng.integers(0, 50, (16, 24))
    f32 = g[:12, :16].astype(np.float32) / 7 - 3
    thunder = scene(20, 29, seed + 62) // 16
    webp = _pil_save(Image.fromarray(g[:16, :16]), "WEBP", lossless=True)
    delta = [{"id": lzma.FILTER_DELTA, "dist": 2}, {"id": lzma.FILTER_LZMA2, "preset": 6}]
    refused = lambda word: {"refused": True, "refusal": word}  # noqa: E731
    return {
        "tiff_lzma_16bit_delta.tif": (
            encode_tiff(g16, bits=16, compression=34925, predictor=2, rows_per_strip=8,
                        squeeze=lambda b: xz(b, filters=delta)),
            "TIFF 16-bit, LZMA with the delta filter, predictor 2"),
        "tiff_zstd_float_pred3.tif": (
            encode_tiff(f32, bits=32, sample_format=3, compression=50000, predictor=3,
                        rows_per_strip=4, squeeze=lambda b: zstd_compress(b, 19, True)),
            "TIFF 32-bit float, ZSTD level 19 with a checksum, predictor 3"),
        "tiff_zstd_tiles.tif": (
            encode_tiff(g, compression=50000, predictor=2, tile=(16, 16),
                        squeeze=lambda b: zstd_compress(b, 1)),
            "TIFF 8-bit, ZSTD in 16 × 16 tiles"),
        "tiff_thunderscan.tif": (encode_tiff_thunder(thunder, rows_per_strip=7, rng=rng),
                                 "TIFF 4-bit ThunderScan, every code"),
        "tiff_repeated_tags.tif": (
            encode_tiff(g, compression=5, rows_per_strip=6,
                        tags=[(259, 3, [8]), (278, 4, [24])]),
            "TIFF LZW in 6-row strips, Compression and RowsPerStrip written again "
            "(Deflate, 24): PIL routes by the last entry, libtiff decodes by the first"),
        "tiff_webp.tif": (encode_tiff(g[:16, :16], compression=50001, codec=lambda blk: webp),
                          "TIFF WebP (Pillow's libtiff has no WebP codec)", refused("WebP")),
        "tiff_sgilog.tif": (encode_tiff(g[:8, :8], compression=34676,
                                        codec=lambda blk: blk.astype(np.uint8).tobytes()),
                            "TIFF SGILog on a min-is-black photometric (libtiff refuses it)",
                            refused("SGILog")),
    }


def gif_webp_files(seed: int) -> dict:
    """name → (bytes, kind[, manifest extras]) of the GIF and WebP
    fixtures: PIL's writer, this file's GIF encoder for the kinds PIL never
    writes, libwebp's own encoder for the VP8 options PIL cannot reach
    (where this Pillow bundles libwebp), hand-built animations and the
    kinds PIL refuses."""
    from PIL import Image

    h, w = H_SMALL, W_SMALL
    g = scene(h, w, seed + 40)
    rgb = scene(h, w, seed + 41, 3)
    rgba = np.dstack([rgb, scene(h, w, seed + 42)])
    im, imc, ima = Image.fromarray(g), Image.fromarray(rgb), Image.fromarray(rgba, "RGBA")
    rng = np.random.default_rng(seed + 43)
    idx = rng.integers(0, 16, (h, w))
    pal = rng.integers(0, 256, (16, 3))
    ident = np.stack([np.arange(16)] * 3, 1)
    frames = [Image.fromarray(scene(h, w, seed + 44 + k, 3)) for k in range(3)]

    def refused(data, kind, word):
        return data, kind, {"refused": True, "refusal": word}

    files = {
        "gif.gif": (_pil_save(im, "GIF"), "GIF (PIL), gray"),
        "gif_quantized.gif": (_pil_save(imc.quantize(200), "GIF"), "GIF (PIL), 200 colours"),
        "gif_interlaced.gif": (_pil_save(imc.quantize(7), "GIF", interlace=True),
                               "GIF (PIL), interlaced, 7 colours"),
        "gif_transparent.gif": (_pil_save(imc.quantize(3), "GIF", transparency=1),
                                "GIF (PIL), transparency index, 3 colours"),
        "gif_animated.gif": (_pil_save(frames[0].quantize(64), "GIF", save_all=True,
                                       append_images=[f.quantize(64) for f in frames[1:]]),
                             "GIF (PIL), animated: frame 0"),
        "gif_identity_global.gif": (encode_gif(idx, palette=ident), "GIF, identity global palette (L)"),
        "gif_identity_local.gif": (encode_gif(idx, palette=pal, local_palette=ident),
                                   "GIF, identity local palette over a global one (L)"),
        "gif_local_palette.gif": (encode_gif(idx, palette=ident, local_palette=pal[::-1]),
                                  "GIF, a local palette over an identity global one"),
        "gif_offset_fill.gif": (encode_gif(idx[:9, :11], screen=(w, h), offset=(5, 7), palette=pal,
                                           transparency=3),
                                "GIF, frame 0 inside the screen, transparency fill"),
        "gif_past_screen.gif": (encode_gif(idx, screen=(20, 10), offset=(6, 4), palette=pal,
                                           interlace=True),
                                "GIF, frame 0 past the screen, interlaced"),
        "gif_code2_no_end.gif": (encode_gif(idx % 4, palette=pal[:4], code_size=2, end_code=False),
                                 "GIF, code size 2, no End code"),
        "gif_code8_short_palette.gif": (encode_gif(idx, palette=pal[:4], code_size=8),
                                        "GIF, code size 8, indices past a 4-entry palette"),
        "gif_extensions.gif": (encode_gif(idx, palette=pal, stray=b"\x07",
                                          extensions=[(254, [b"comment", b"more"]),
                                                      (255, [b"NETSCAPE2.0", b"\x01\x00\x00"]),
                                                      (1, b"plain text")]),
                               "GIF, blocks before the image: comment, NETSCAPE, plain text, a stray byte"),
        "gif_code13.gif": refused(encode_gif(idx, palette=pal, code_size=13),
                                  "GIF, LZW code size 13", "LZW minimum code size"),
        "webp.webp": (_pil_save(imc, "WEBP", lossless=True), "WebP lossless (PIL)"),
        "webp_lossless_alpha.webp": (_pil_save(ima, "WEBP", lossless=True, exact=True),
                                     "WebP lossless RGBA, exact (PIL)"),
        "webp_lossy.webp": (_pil_save(imc, "WEBP", quality=90), "WebP lossy, quality 90 (PIL)"),
        "webp_lossy_gray_q0.webp": (_pil_save(im, "WEBP", quality=0, method=0),
                                    "WebP lossy gray, quality 0, method 0 (PIL)"),
        "webp_lossy_odd.webp": (_pil_save(Image.fromarray(scene(23, 37, seed + 47, 3)), "WEBP",
                                          quality=60, method=6),
                                "WebP lossy 37×23, method 6 (PIL)"),
        "webp_lossy_alpha.webp": (_pil_save(ima, "WEBP", quality=75, alpha_quality=50),
                                  "WebP lossy + ALPH (VP8L alpha), alpha quality 50 (PIL)"),
        "webp_animated.webp": (_pil_save(frames[0], "WEBP", save_all=True,
                                         append_images=frames[1:], quality=80),
                               "WebP animated (PIL): frame 0"),
        "webp_anim_offset.webp": (webp_animation((w + 10, h + 8), [
            (_pil_save(imc, "WEBP", lossless=True), 6, 4),
            (_pil_save(frames[1], "WEBP", quality=70), 0, 0)]),
            "WebP animated, frame 0 (VP8L) at (6, 4) on a larger canvas"),
        "webp_anim_offset_alpha.webp": (webp_animation((w + 4, h + 2), [
            (_pil_save(ima, "WEBP", quality=70), 2, 2)], flags=0x12),
            "WebP animated, frame 0 lossy + ALPH at (2, 2)"),
        "webp_vp8l_writer.webp": (encode_vp8l_gray(g), "WebP VP8L gray (this file's writer)"),
    }
    # two single-bit flips PIL reads (found by flipping every bit of these
    # files): a VP8 coefficient past an encoder's range, which libwebp's
    # 16-bit SIMD transform wraps; a VP8L alpha plane read past its end,
    # which libwebp's 8-bit alpha path accepts once every pixel is decoded
    wrap = bytearray(_pil_save(Image.fromarray(scene(90, 120, 3, 3)), "WEBP", quality=40))
    wrap[53] ^= 1 << 1
    files["webp_coefficient_wrap.webp"] = (bytes(wrap), "WebP lossy, a coefficient past the "
                                           "encoder's range (one bit flipped)")
    past = bytearray(_pil_save(Image.fromarray(np.dstack([scene(60, 80, 7, 3), scene(60, 80, 8)]),
                                               "RGBA"), "WEBP", quality=60, alpha_quality=30))
    past[104] ^= 1 << 2
    files["webp_alpha_past_end.webp"] = (bytes(past), "WebP lossy + ALPH read past its end "
                                         "(one bit flipped)")
    lossy = bytearray(files["webp_lossy.webp"][0])
    lossy[20] |= 1  # the frame tag's key-frame bit: an inter frame
    files["webp_interframe.webp"] = refused(bytes(lossy), "WebP VP8 inter frame", "VP8 frame")
    lossless = bytearray(files["webp.webp"][0])
    lossless[24] |= 0x20  # the VP8L version field
    files["webp_vp8l_version1.webp"] = refused(bytes(lossless), "WebP VP8L version 1",
                                               "VP8L header")
    alpha = bytearray(files["webp_lossy_alpha.webp"][0])
    alpha[alpha.index(b"ALPH") + 8] = 2  # compression method 2
    files["webp_alph_method2.webp"] = refused(bytes(alpha), "WebP ALPH method 2", "ALPH chunk")
    lib = libwebp()
    if lib is not None:
        for name, kind, cfg in (
                ("webp_simple_filter", "simple loop filter, sharpness 3",
                 dict(filter_type=0, filter_strength=80, filter_sharpness=3)),
                ("webp_partitions8", "8 token partitions, sharpness 7",
                 dict(partitions=3, low_memory=1, filter_sharpness=7)),
                ("webp_one_segment_no_filter", "one segment, filter strength 0",
                 dict(segments=1, filter_strength=0)),
                ("webp_raw_alpha", "raw ALPH, gradient filter",
                 dict(alpha_compression=0, alpha_filtering=2))):
            files[name + ".webp"] = (libwebp_encode(lib, rgba if "alpha" in name else rgb,
                                                    quality=70.0, **cfg),
                                     f"WebP lossy (libwebp), {kind}")
    return files


# ---------------------------------------------------- QOI, Sun, PCX, SGI, TGA,
# ICO, CUR, DIB and DDS: numpy encoders (the card's machine has no PIL)


def encode_qoi(rgb, channels: int = 3, ops=None) -> bytes:
    """A QOI file of (H, W, 3) or (H, W, 4) pixels, coded with every op the
    format has (index, diff, luma, run, RGB, RGBA), as the reference coder
    chooses them; ``ops`` (bytes) replaces the coded stream."""
    px = np.asarray(rgb, np.uint8)
    H, W = px.shape[:2]
    if px.shape[2] == 3:
        px = np.dstack([px, np.full((H, W), 255, np.uint8)])
    out = bytearray(b"qoif" + struct.pack(">IIBB", W, H, channels, 0))
    if ops is not None:
        return bytes(out) + bytes(ops)
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    run = 0
    flat = [tuple(int(v) for v in p) for p in px.reshape(-1, 4)]
    for i, p in enumerate(flat):
        if p == prev:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        if seen[h] == p:
            out.append(h)
        elif p[3] == prev[3]:
            dr, dg, db = ((p[c] - prev[c] + 128) % 256 - 128 for c in range(3))
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
            else:
                out += bytes([0xFE, *p[:3]])
        else:
            out += bytes([0xFF, *p])
        seen[h] = p
        prev = p
    return bytes(out) + bytes(7) + b"\x01"


def sun_rle(data: bytes) -> bytes:
    """Sun's byte RLE: runs of 3 or more (and any 0x80) as 0x80, n - 1, v."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        n = j - i
        if n >= 3:
            out += bytes([0x80, n - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00" * n
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def encode_sun(pixels, depth: int = 8, ftype: int = 1, palette=None, rle=None) -> bytes:
    """A Sun raster file: 1-bit (1 = black), 4-, 8-bit gray or indices,
    24/32-bit BGR(X) (type 3: RGB(X)); rows padded to 16 bits when raw,
    unpadded under RLE (type 2); ``palette`` (N, 3) written as R, G, B
    planes; ``rle`` replaces the coded data."""
    px = np.asarray(pixels)
    H, W = px.shape[:2]
    if depth in (1, 4):
        bits = np.unpackbits(px.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
        rows = [np.packbits(r.reshape(-1)).tobytes() for r in bits]
    elif depth == 8:
        rows = [r.astype(np.uint8).tobytes() for r in px]
    else:
        c = px[..., [0, 1, 2] if ftype == 3 else [2, 1, 0]].astype(np.uint8)
        if depth == 32:
            c = np.dstack([c, np.zeros((H, W), np.uint8)])
        rows = [r.tobytes() for r in c]
    stride = ((W * depth + 15) // 16) * 2
    if ftype == 2:
        body = rle if rle is not None else sun_rle(b"".join(rows))
    else:
        body = b"".join(r.ljust(stride, b"\0") for r in rows)
    pal = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, W, H, depth, len(body), ftype, 1 if pal else 0,
                       len(pal)) + pal + body


def pcx_rle(line: bytes) -> bytes:
    """PCX run length: runs of up to 63 (and any byte of 0xC0 or more) as
    0xC0 | n, v; other bytes as themselves."""
    out, i = bytearray(), 0
    while i < len(line):
        j = i
        while j < len(line) and j - i < 63 and line[j] == line[i]:
            j += 1
        if j - i > 1 or line[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), line[i]])
        else:
            out.append(line[i])
        i = j
    return bytes(out)


def encode_pcx(pixels, bits: int = 8, planes: int = 1, version: int = 5, palette16=None,
               palette256=None, stride=None, origin=(0, 0), body=None) -> bytes:
    """A PCX file: 1-bit (1 plane), 1-bit planes (2 or 4, P with the header's
    16 colours), 8-bit (L, or P with a 256-colour palette after 0x0C) and
    8-bit RGB planes; each line coded by run length (runs end with the
    line); ``stride`` the header's bytes per plane line (even if None)."""
    px = np.asarray(pixels)
    H, W = px.shape[:2]
    st = (W * bits + 7) // 8
    if stride is None:
        stride = st + st % 2
    lines = []
    for y in range(H):
        if planes == 3:
            pls = [px[y, :, c].astype(np.uint8).tobytes() for c in range(3)]
        elif bits == 1:
            pls = [np.packbits(((px[y].astype(np.int64) >> b) & 1).astype(np.uint8)).tobytes()
                   for b in range(planes)]
        else:
            pls = [px[y].astype(np.uint8).tobytes()]
        lines.append(b"".join(p[:stride].ljust(stride, b"\0") for p in pls))
    data = body if body is not None else b"".join(pcx_rle(ln) for ln in lines)
    hdr = bytearray(128)
    x0, y0 = origin
    struct.pack_into("<BBBBHHHHHH", hdr, 0, 10, version, 1, bits, x0, y0, x0 + W - 1, y0 + H - 1,
                     72, 72)
    if palette16 is not None:
        hdr[16:64] = np.asarray(palette16, np.uint8).reshape(-1)[:48].tobytes().ljust(48, b"\0")
    hdr[65] = planes
    struct.pack_into("<HH", hdr, 66, stride, 1)
    tail = b""
    if palette256 is not None:
        tail = b"\x0c" + np.asarray(palette256, np.uint8).reshape(-1).tobytes()
    return bytes(hdr) + data + tail


def sgi_rle_row(row: bytes, bpc: int) -> bytes:
    """One SGI RLE row: runs (count, value) and copies (0x80 | count, values),
    127 at most, then a 0 code; codes are bpc bytes wide."""
    vals = [row[i:i + bpc] for i in range(0, len(row), bpc)]
    out, i = bytearray(), 0

    def code(c):
        return b"\0" * (bpc - 1) + bytes([c])

    while i < len(vals):
        j = i
        while j < len(vals) and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 2:
            out += code(j - i) + vals[i]
            i = j
            continue
        j = i + 1
        while j < len(vals) and j - i < 127 and not (j + 1 < len(vals) and vals[j] == vals[j + 1]):
            j += 1
        out += code(0x80 | (j - i)) + b"".join(vals[i:j])
        i = j
    return bytes(out + code(0))


def encode_sgi(pixels, bpc: int = 1, rle: bool = True, dimension=None) -> bytes:
    """An SGI file of (H, W) or (H, W, Z) samples (1 or 2 bytes each, rows
    bottom-up), verbatim or RLE with its offset and length tables."""
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[..., None]
    H, W, Z = px.shape
    dim = dimension or (3 if Z > 1 else 2)
    head = bytearray(512)
    struct.pack_into(">hBBHHHH", head, 0, 474, 1 if rle else 0, bpc, dim, W, H, Z)
    struct.pack_into(">ii", head, 12, 0, 255 if bpc == 1 else 65535)
    dt = np.dtype(">u2") if bpc == 2 else np.uint8
    planes = [px[::-1, :, c].astype(dt) for c in range(Z)]
    if not rle:
        return bytes(head) + b"".join(p.tobytes() for p in planes)
    starts, lengths, data = [], [], bytearray()
    base = 512 + 8 * H * Z
    for c in range(Z):
        for y in range(H):
            coded = sgi_rle_row(planes[c][y].tobytes(), bpc)
            starts.append(base + len(data))
            lengths.append(len(coded) // bpc)
            data += coded
    return (bytes(head) + struct.pack(f">{H * Z}I", *starts) + struct.pack(f">{H * Z}I", *lengths)
            + bytes(data))


def tga_rle(rows, pb: int) -> bytes:
    """TGA RLE over the rows: runs of 2 to 128 pixels within a row (PIL
    refuses a run across rows), literals of 1 to 128 that may cross rows."""
    W = len(rows[0]) // pb
    px = [r[i:i + pb] for r in rows for i in range(0, len(r), pb)]
    out, i = bytearray(), 0
    while i < len(px):
        j = i
        while j < len(px) and j - i < 128 and px[j] == px[i] and j // W == i // W:
            j += 1
        if j - i >= 2:
            out += bytes([0x80 | (j - i - 1)]) + px[i]
            i = j
            continue
        j = i + 1
        while j < len(px) and j - i < 128 and not (
                j + 1 < len(px) and px[j] == px[j + 1] and (j + 1) // W == j // W):
            j += 1
        out += bytes([j - i - 1]) + b"".join(px[i:j])
        i = j
    return bytes(out)


def encode_tga(pixels, itype: int = 3, depth: int = 8, cmap=None, cmap_depth: int = 24,
               cmap_start: int = 0, top_down: bool = False, flip: bool = False,
               ident: bytes = b"", rle=None) -> bytes:
    """A TGA file: types 1-3 (9-11 RLE, ``rle`` replacing the packets);
    8-bit indices or gray, 1-bit, 16-bit gray + alpha (H, W, 2) or 5-5-5
    colour, 24/32-bit BGR(A); a 16- or 24-bit colour map from
    ``cmap_start``; ``top_down`` sets bit 0x20, ``flip`` bit 0x10 (rows
    stored right to left)."""
    px = np.asarray(pixels)
    H, W = px.shape[:2]
    if depth == 1:
        rows = [np.packbits(r.astype(np.uint8)).tobytes() for r in px]
    elif depth == 8:
        rows = [r.astype(np.uint8).tobytes() for r in px]
    elif depth == 16 and (itype & 7) == 3:
        rows = [r.astype(np.uint8).tobytes() for r in px]
    elif depth == 16:
        c = px.astype(np.uint16)
        v = (c[..., 0] >> 3) << 10 | (c[..., 1] >> 3) << 5 | (c[..., 2] >> 3) | 0x8000
        rows = [r.astype("<u2").tobytes() for r in v]
    else:
        c = px[..., [2, 1, 0] + ([3] if depth == 32 else [])].astype(np.uint8)
        rows = [r.tobytes() for r in c]
    pb = max(depth // 8, 1)
    if flip:
        rows = [b"".join(r[i:i + pb] for i in range(len(r) - pb, -1, -pb)) for r in rows]
    if not top_down:
        rows = rows[::-1]
    body = rle if rle is not None else (tga_rle(rows, pb) if itype & 8 else b"".join(rows))
    cm = b""
    if cmap is not None:
        c = np.asarray(cmap, np.uint16)
        if cmap_depth == 16:
            cm = ((c[:, 0] >> 3) << 10 | (c[:, 1] >> 3) << 5 | (c[:, 2] >> 3)).astype(
                "<u2").tobytes()
        else:
            cm = c[:, [2, 1, 0] + ([3] if cmap_depth == 32 else [])].astype(np.uint8).tobytes()
    n = len(cmap) if cmap is not None else 0
    flags = (0x20 if top_down else 0) | (0x10 if flip else 0)
    return (struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap is not None else 0, itype,
                        cmap_start, n, cmap_depth if cmap is not None else 0, 0, 0, W, H, depth,
                        flags) + ident + cm + body)


def encode_dib(pixels, bits: int = 8, palette=None, header: int = 40, **kw) -> bytes:
    """A headerless DIB: ``encode_bmp``'s file without its 14-byte header;
    the pixels follow the header, masks and palette."""
    return encode_bmp(pixels, bits, header=header, palette=palette, **kw)[14:]


def ico_dib(pixels, bits: int = 32, palette=None, mask=None) -> bytes:
    """An ICO/CUR DIB entry: the XOR bitmap at twice its height (40-byte
    header), then the AND mask rows (1 bit, 32-bit aligned), bottom-up."""
    px = np.asarray(pixels)
    H, W = px.shape[:2]
    dib = encode_dib(px, bits, palette=palette)
    hdr = bytearray(dib[:40])
    struct.pack_into("<i", hdr, 8, 2 * H)
    m = np.zeros((H, W), np.uint8) if mask is None else np.asarray(mask, np.uint8)
    rows = np.zeros((H, (W + 31) // 32 * 32), np.uint8)
    rows[:, :W] = m
    return bytes(hdr) + dib[40:] + np.packbits(rows[::-1], axis=1).tobytes()


def encode_ico(entries, kind: int = 1, dims=None) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) of entries (the bytes of a PNG or of
    ``ico_dib``), each with its (width, height, colours, bpp) in the
    directory (``dims``; the entry's own size, 0 colours and its bits if
    None)."""
    out = bytearray(struct.pack("<HHH", 0, kind, len(entries)))
    offset = 6 + 16 * len(entries)
    body = bytearray()
    for i, e in enumerate(entries):
        if dims is not None:
            w, h, nc, bpp = dims[i]
        elif e[:8] == b"\x89PNG\r\n\x1a\n":
            w, h = struct.unpack(">II", e[16:24])
            nc, bpp = 0, 32
        else:
            w, h = struct.unpack("<ii", e[4:12])
            h //= 2
            nc, bpp = 0, struct.unpack("<H", e[14:16])[0]
        out += struct.pack("<BBBBHHII", w % 256, h % 256, nc, 0, 1, bpp, len(e),
                           offset + len(body))
        body += e
    return bytes(out + body)


def encode_dds(data, w: int, h: int, fourcc: bytes = b"DXT1", dxgi=None, pfflags: int = 0x4,
               bitcount: int = 0, masks=(0, 0, 0, 0)) -> bytes:
    """A DDS file: the 124-byte header, its pixel format (a FourCC; bit
    masks with ``pfflags`` 0x40 or 0x41; luminance 0x20000; palette 0x20),
    a DX10 header where ``dxgi`` is given, then ``data``."""
    hdr = bytearray(124)
    struct.pack_into("<IIII", hdr, 0, 124, 0x1007, h, w)
    struct.pack_into("<I", hdr, 72, 32)
    struct.pack_into("<I", hdr, 76, pfflags)
    hdr[80:84] = fourcc if pfflags & 0x4 else b"\0\0\0\0"
    struct.pack_into("<I", hdr, 84, bitcount)
    struct.pack_into("<4I", hdr, 88, *masks)
    struct.pack_into("<I", hdr, 104, 0x1000)
    out = b"DDS " + bytes(hdr)
    if dxgi is not None:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return out + bytes(data)


def _blocks(img, w: int, h: int):
    """(h / 4, w / 4, 16, C) 4×4 blocks of an (h, w, C) image, its edges
    repeated to a multiple of 4."""
    img = np.asarray(img)
    H4, W4 = (h + 3) // 4 * 4, (w + 3) // 4 * 4
    pad = np.pad(img, ((0, H4 - h), (0, W4 - w), (0, 0)), mode="edge")
    return pad.reshape(H4 // 4, 4, W4 // 4, 4, -1).transpose(0, 2, 1, 3, 4).reshape(
        H4 // 4, W4 // 4, 16, -1)


def bc1_blocks(rgb) -> bytes:
    """BC1 (DXT1) blocks of an (H, W, 3) image: each block's darkest and
    brightest pixels (by luma) as its 5-6-5 endpoints, four colours."""
    h, w = rgb.shape[:2]
    b = _blocks(rgb, w, h).astype(np.int64)
    luma = b @ np.array([2, 4, 1])
    lo = np.take_along_axis(b, luma.argmin(-1)[..., None, None], 2)[:, :, 0]
    hi = np.take_along_axis(b, luma.argmax(-1)[..., None, None], 2)[:, :, 0]

    def c565(c):
        return (c[..., 0] >> 3) << 11 | (c[..., 1] >> 2) << 5 | (c[..., 2] >> 3)

    c0, c1 = c565(hi), c565(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    t = (luma - luma.min(-1, keepdims=True)) / np.maximum(np.ptp(luma, -1, keepdims=True), 1)
    t = np.where(swap[..., None], 1 - t, t)  # 1 at c0's pixel, 0 at c1's
    idx = np.select([t > 5 / 6, t > 1 / 2, t > 1 / 6], [0, 2, 3], 1)
    idx = np.where((c0 > c1)[..., None], idx, 0)
    lut = (idx << (2 * np.arange(16))).sum(-1)
    out = np.zeros(b.shape[:2] + (8,), np.uint8)
    out[..., 0], out[..., 1] = c0 & 255, c0 >> 8
    out[..., 2], out[..., 3] = c1 & 255, c1 >> 8
    for k in range(4):
        out[..., 4 + k] = (lut >> (8 * k)) & 255
    return out.tobytes()


def bc7_blocks(rgba) -> bytes:
    """BC7 mode 6 blocks of an (H, W, 4) image: each block's per-channel
    minimum and maximum as its 7-bit endpoints (p-bits 0 and 1), 4-bit
    indices by the nearest weight along the colour sum."""
    h, w = rgba.shape[:2]
    b = _blocks(rgba, w, h).astype(np.int64)
    ex0, ex1 = (b.min(2) >> 1) << 1, (b.max(2) >> 1) << 1 | 1
    span = np.maximum((ex1 - ex0)[..., :3].sum(-1), 1)
    t = ((b[..., :3] - ex0[:, :, None, :3]).sum(-1) / span[..., None]).clip(0, 1)
    weights = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]) / 64
    idx = np.abs(t[..., None] - weights).argmin(-1)
    flip = idx[..., 0] >= 8  # the anchor index has 3 bits: swap the endpoints
    ex0, ex1 = np.where(flip[..., None], ex1, ex0), np.where(flip[..., None], ex0, ex1)
    idx = np.where(flip[..., None], 15 - idx, idx)
    out = bytearray()
    for by in range(b.shape[0]):
        for bx in range(b.shape[1]):
            v, pos = 1 << 6, 7  # mode 6
            for c in range(4):
                for e in (ex0[by, bx, c], ex1[by, bx, c]):
                    v |= int(e >> 1) << pos
                    pos += 7
            v |= int(ex0[by, bx, 0] & 1) << pos | int(ex1[by, bx, 0] & 1) << (pos + 1)
            pos += 2
            for i in range(16):
                v |= int(idx[by, bx, i]) << pos
                pos += 3 if i == 0 else 4
            out += v.to_bytes(16, "little")
    return bytes(out)


# ------------------------------------- PSD, DCX, BLP, FTEX, ICNS, P0CMYK, Py
def psd_packbits(row: bytes) -> bytes:
    """PackBits (Apple's; PSD's rows): runs of 3 to 128 equal bytes as
    (257 - n, byte), the bytes between as literals of up to 128 (n - 1,
    bytes)."""
    a = np.frombuffer(bytes(row), np.uint8)
    out, lit = bytearray(), 0  # lit: where the pending literal starts

    def flush(end):
        for i in range(lit, end, 128):
            k = min(128, end - i)
            out.append(k - 1)
            out.extend(a[i:i + k].tobytes())

    if not len(a):
        return b""
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]]).tolist()
    for s0, s1 in zip(starts, starts[1:] + [len(a)]):
        if s1 - s0 < 3:
            continue
        flush(s0)
        while s1 - s0 >= 3:
            k = min(128, s1 - s0)
            out += bytes([257 - k, int(a[s0])])
            s0 += k
        lit = s0
    flush(len(a))
    return bytes(out)


def psd_resource(rid: int, data: bytes, name: bytes = b"") -> bytes:
    """One image resource block: 8BIM, its id, a Pascal name padded to an
    even length, its data padded to an even length."""
    pname = bytes([len(name)]) + name
    pname += b"\0" * (len(pname) % 2)
    return (b"8BIM" + struct.pack(">H", rid) + pname + struct.pack(">I", len(data)) + data
            + b"\0" * (len(data) % 2))


def encode_psd(pixels, mode: int = 1, bits: int = 8, compression: int = 0, channels=None,
               palette=None, resources: bytes = b"", layers=None, version: int = 1) -> bytes:
    """A PSD file of one merged image: the header (``mode``: 0 bitmap, 1 gray,
    2 indexed, 3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 Lab; ``channels``
    in the header, the planes' count if None), the colour mode data (an
    indexed image's 768-byte planar palette), ``resources`` (the image
    resource section's blocks), the layer and mask section (``layers``: the
    layer info's bytes, none if None), then the planes: raw (0) or PackBits
    (1) with the byte count of every row of every plane first. ``pixels``:
    (H, W) or (H, W, C) uint8; at 1 bit, 0/1 with 1 white."""
    px = np.asarray(pixels)
    planes = [px] if px.ndim == 2 else [px[..., c] for c in range(px.shape[2])]
    H, W = px.shape[:2]
    rows = [[(np.packbits(pl[y].astype(np.uint8)) if bits == 1 else pl[y].astype(np.uint8))
             .tobytes() for y in range(H)] for pl in planes]
    out = b"8BPS" + struct.pack(">H6xHIIHH", version, len(planes) if channels is None else channels,
                                H, W, bits, mode)
    cmd = b"" if palette is None else np.asarray(palette, np.uint8).T.reshape(-1).tobytes()
    out += struct.pack(">I", len(cmd)) + cmd + struct.pack(">I", len(resources)) + resources
    if layers is None:
        out += struct.pack(">I", 0)
    else:
        out += struct.pack(">II", 4 + len(layers), len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression == 1:
        packed = [[psd_packbits(r) for r in pl] for pl in rows]
        out += b"".join(struct.pack(">H", len(r)) for pl in packed for r in pl)
        return out + b"".join(r for pl in packed for r in pl)
    return out + b"".join(r for pl in rows for r in pl)


def encode_dcx(frames, offsets=None) -> bytes:
    """A DCX file: the offset table (the frames' own, or ``offsets``) ended
    by 0, then the PCX frames."""
    if offsets is None:
        at, offsets = 4 + 4 * (len(frames) + 1), []
        for f in frames:
            offsets.append(at)
            at += len(f)
    head = struct.pack("<I", 0x3ADE68B1) + b"".join(struct.pack("<I", o) for o in offsets)
    return head + struct.pack("<I", 0) + b"".join(frames)


def bgra_palette(colours) -> bytes:
    """256 BGRA entries of an (n, 3) or (n, 4) palette (alpha 255 where
    absent), zero-filled past n."""
    c = np.asarray(colours, np.int64)
    pal = np.zeros((256, 4), np.uint8)
    pal[:len(c), :3] = c[:, 2::-1][:, :3] if c.shape[1] == 3 else c[:, [2, 1, 0]]
    pal[:len(c), 3] = 255 if c.shape[1] == 3 else c[:, 3]
    return pal.tobytes()


def encode_blp(version: int, w: int, h: int, data: bytes, compression: int = 1,
               encoding: int = 1, alpha: int = 0, alpha_encoding: int = 0, palette=None,
               jpeg_header: bytes = b"", offset=None, length=None) -> bytes:
    """A BLP1 or BLP2 file of one mipmap: the header (BLP1: compression,
    alpha flag, size, encoding; BLP2: compression, encoding, alpha depth,
    alpha encoding), the 16 mipmap offsets and lengths (mipmap 0's own, or
    ``offset`` and ``length``), then: BLP1 JPEG (compression 0) the JPEG
    header's length, ``jpeg_header`` and ``data``; a palette kind the 256
    BGRA entries of ``palette`` and ``data``."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbBII", compression, encoding, alpha, alpha_encoding, 1,
                                     w, h)
    at = len(head) + 128
    if version == 1 and compression == 0:
        pre = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        pre = bgra_palette(np.zeros((0, 3)) if palette is None else palette)
    at += len(pre)
    table = struct.pack("<16I", at if offset is None else offset, *[0] * 15)
    table += struct.pack("<16I", len(data) if length is None else length, *[0] * 15)
    return head + table + pre + data


def dxt_blocks(rgba, kind: int) -> bytes:
    """DXT1, DXT3 or DXT5 blocks of an (H, W, 4) image: BC1 colour
    (``bc1_blocks``), and DXT3's 4-bit alpha or DXT5's alpha endpoints
    (the block's largest and smallest) with the nearest of their eight
    levels."""
    h, w = rgba.shape[:2]
    colour = np.frombuffer(bc1_blocks(rgba[..., :3]), np.uint8).reshape(-1, 8)
    if kind == 1:
        return colour.tobytes()
    a = _blocks(rgba[..., 3:], w, h).reshape(-1, 16).astype(np.int64)
    if kind == 3:
        q = (a + 8) // 17
        alpha = (q[:, 0::2] | q[:, 1::2] << 4).astype(np.uint8)
    else:
        a0, a1 = a.max(1), a.min(1)
        levels = np.stack([a0, a1] + [((7 - k) * a0 + k * a1) // 7 for k in range(1, 7)], 1)
        idx = np.abs(a[:, :, None] - levels[:, None, :]).argmin(-1)
        idx = np.where((a0 > a1)[:, None], idx, 0)
        bitsv = (idx << (3 * np.arange(16))).sum(-1)
        alpha = np.zeros((len(a), 8), np.uint8)
        alpha[:, 0], alpha[:, 1] = a0, a1
        for k in range(6):
            alpha[:, 2 + k] = (bitsv >> (8 * k)) & 255
    return np.concatenate([alpha, colour], 1).tobytes()


def encode_ftex(w: int, h: int, data: bytes, fmt: int = 0, where=None, size=None,
                formats: int = 1) -> bytes:
    """An FTEX file: the header (size, one mipmap, ``formats`` formats, the
    format and where its mipmap is), then the mipmap's size and ``data``."""
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<i2i2i2i", 0, w, h, 1, formats, fmt, where)
    head = head.ljust(where, b"\0")
    return head + struct.pack("<i", len(data) if size is None else size) + data


def icns_rle(plane: bytes) -> bytes:
    """One plane of an ICNS RGB icon: runs of 3 to 130 equal bytes as
    (n + 125, byte), the bytes between as literals of up to 128 (n - 1,
    bytes)."""
    a = np.frombuffer(bytes(plane), np.uint8)
    out = bytearray()
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]]).tolist() + [len(a)]
    lit = 0
    for s0, s1 in zip(starts, starts[1:]):
        if s1 - s0 < 3:
            continue
        for j in range(lit, s0, 128):
            k = min(128, s0 - j)
            out += bytes([k - 1]) + a[j:j + k].tobytes()
        while s1 - s0 >= 3:
            k = min(130, s1 - s0)
            out += bytes([k + 125, int(a[s0])])
            s0 += k
        lit = s0
    for j in range(lit, len(a), 128):
        k = min(128, len(a) - j)
        out += bytes([k - 1]) + a[j:j + k].tobytes()
    return bytes(out)


def icns_rgb(rgb, rle: bool = True) -> bytes:
    """An ICNS RGB icon of an (H, W, 3) image: three RLE planes, or the
    pixels interleaved."""
    rgb = np.asarray(rgb, np.uint8)
    if not rle:
        return rgb.tobytes()
    return b"".join(icns_rle(rgb[..., c].tobytes()) for c in range(3))


def encode_icns(blocks, filesize=None) -> bytes:
    """An ICNS file of (type, payload) blocks in order."""
    body = b"".join(t + struct.pack(">I", 8 + len(p)) + p for t, p in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body) if filesize is None else filesize) + body


def encode_pillow_pnm(magic: bytes, samples, maxval: int = 255) -> bytes:
    """Pillow's own netpbm kinds (P0CMYK, PyCMYK, PyRGBA, PyP): the header,
    then ``samples`` ((H, W) or (H, W, C), in 0..65535) as bytes, or as
    big-endian 16-bit words past maxval 255."""
    px = np.asarray(samples)
    H, W = px.shape[:2]
    dt = ">u2" if maxval > 255 else np.uint8
    return magic + b"\n%d %d\n%d\n" % (W, H, maxval) + np.ascontiguousarray(px, dt).tobytes()


def unported_files(seed: int) -> dict:
    """One small file of each format PIL identifies by a signature and the
    port does not read yet, PIL's writer where it has one; each refused
    naming its format."""
    from PIL import Image

    h, w = 24, 32
    g = scene(h, w, seed + 30)
    rgb = scene(h, w, seed + 31, 3)
    im, imc = Image.fromarray(g), Image.fromarray(rgb)

    def un(word):
        return {"refused": True, "refusal": word, "pil_reads": True}

    return {
        "jp2.jp2": (_pil_save(im, "JPEG2000"), "JPEG 2000, JP2 box (PIL)", un("JPEG 2000")),
        "j2k.j2k": (_pil_save(im, "JPEG2000", no_jp2=True), "JPEG 2000 codestream (PIL)",
                    un("JPEG 2000")),
        "avif.avif": (_pil_save(imc, "AVIF"), "AVIF (PIL)", un("AVIF")),
    }


def container_files(seed: int) -> dict:
    """The PSD, DCX, BLP, FTEX, ICNS and Pillow netpbm fixtures: the two
    files these formats had while the port refused them (``psd.psd``,
    ``p0cmyk.pnm``; the same bytes), a PackBits RGB PSD, a DCX, a BLP1 of
    PIL's JPEG and a BLP2 of DXT5 blocks, an FTEX of BC1 blocks, ICNS files
    whose best size is an RLE icon and a PNG, a PyCMYK at maxval 200, and an
    ICNS whose best size is JPEG 2000 (PIL reads it; the port refuses it)."""
    from PIL import Image

    h, w = 24, 32
    g = scene(h, w, seed + 30)
    rgb = scene(h, w, seed + 31, 3)
    psd = (b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, h, w, 8, 1) + struct.pack(">III", 0, 0, 0)
           + struct.pack(">H", 0) + g.tobytes())
    rgba = np.dstack([rgb, g])
    jpeg = _pil_save(Image.fromarray(rgb), "JPEG", quality=80)
    split = jpeg.index(b"\xff\xda")  # the header BLP1 keeps apart: up to the scan
    icon = scene(16, 16, seed + 32, 3)
    png32 = _pil_save(Image.fromarray(scene(32, 32, seed + 33, 3)), "PNG")
    j2k = _pil_save(Image.fromarray(scene(32, 32, seed + 34, 3)), "JPEG2000", no_jp2=True)
    return {
        "psd.psd": (psd, "PSD, 8-bit grayscale, raw"),
        "p0cmyk.pnm": (b"P0CMYK\n%d %d\n255\n" % (w, h)
                       + np.dstack([rgb, g]).astype(np.uint8).tobytes(),
                       "netpbm P0CMYK (Pillow's own kind)"),
        "psd_packbits_rgb.psd": (encode_psd(rgb, 3, compression=1,
                                            resources=psd_resource(1005, bytes(16)),
                                            layers=bytes(8)),
                                 "PSD, RGB, PackBits, a resource and an empty layer section"),
        "dcx.dcx": (encode_dcx([encode_pcx(g, 8, 1), encode_pcx(g[::-1], 8, 1)]),
                    "DCX of two 8-bit PCX frames"),
        "blp1_jpeg.blp": (encode_blp(1, w, h, jpeg[split:], compression=0, encoding=1,
                                     jpeg_header=jpeg[:split]),
                          "BLP1, PIL's RGB JPEG (red and blue swapped by the plugin)"),
        "blp2_dxt5.blp": (encode_blp(2, w, h, dxt_blocks(rgba, 5), encoding=2, alpha=8,
                                     alpha_encoding=7),
                          "BLP2, DXT5, 8-bit alpha"),
        "ftex_dxt1.ftc": (encode_ftex(w - 3, h - 2, bc1_blocks(rgb[:h - 2, :w - 3])),
                          "FTEX, DXT1, 29×22"),
        "icns_rle.icns": (encode_icns([(b"is32", icns_rgb(icon)),
                                       (b"s8mk", scene(16, 16, seed + 35).tobytes())]),
                          "ICNS, a 16×16 RLE icon and its mask"),
        "icns_png.icns": (encode_icns([(b"is32", icns_rgb(icon)), (b"ic11", png32)]),
                          "ICNS, a 32×32 PNG (16×16 at scale 2) over a 16×16 RLE icon"),
        "pycmyk.pnm": (encode_pillow_pnm(b"PyCMYK", rgba.astype(np.int64) * 200 // 255, 200),
                       "netpbm PyCMYK at maxval 200 (Pillow's own kind)"),
        "icns_jp2.icns": (encode_icns([(b"is32", icns_rgb(icon)), (b"ic11", j2k)]),
                          "ICNS whose best size is a JPEG 2000 codestream (PIL)",
                          {"refused": True, "refusal": "JPEG 2000", "pil_reads": True}),
    }


# ------------------------------------------------- raw-layout plugins
# numpy-only encoders of the formats PIL reads behind a small header (the
# card's machine has no PIL): MSP, XBM, XPM, IM, IMT, IPTC, SPIDER, GBR,
# McIDAS, PIXAR, XVThumb, FITS, FLI / FLC and PCD


def msp_rows(bits) -> list:
    """An MSP LinS image's rows: (H, W) of 0/1 (1 white) packed MSB first,
    each row coded as runs (0, count, byte) of repeated bytes and literals
    (count, bytes...)."""
    packed = np.packbits(np.asarray(bits, np.uint8), axis=1)
    rows = []
    for r in packed:
        out, i = bytearray(), 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, r[i]])
                i = j
                continue
            k = i
            while k < len(r) and k - i < 255 and not (k + 2 < len(r) and r[k] == r[k + 1] == r[k + 2]):
                k += 1
            out += bytes([k - i]) + bytes(r[i:k])
            i = k
        rows.append(bytes(out))
    return rows


def encode_msp(bits, kind: bytes = b"DanM", rows=None, checksum=None) -> bytes:
    """(H, W) of 0/1 (1 white) as MSP: "DanM" raw bits at 32, or "LinS" a
    row map of 16-bit lengths and RLE rows (``msp_rows``, or ``rows``); the
    header's 16 words XOR to 0 unless ``checksum`` is given."""
    bits = np.asarray(bits, np.uint8)
    H, W = bits.shape
    words = [struct.unpack("<H", kind[:2])[0], struct.unpack("<H", kind[2:4])[0], W, H,
             1, 1, 1, 1, W, H, 0, 0, 0, 0, 0, 0]
    x = 0
    for w in words:
        x ^= w
    words[12] = x if checksum is None else checksum
    head = struct.pack("<16H", *words)
    if kind == b"DanM":
        return head + np.packbits(bits, axis=1).tobytes()
    rows = msp_rows(bits) if rows is None else rows
    return head + struct.pack(f"<{len(rows)}H", *[len(r) for r in rows]) + b"".join(rows)


def encode_xbm(bits, name: bytes = b"im", hotspot=None, per_line: int = 12,
               sep: bytes = b", ") -> bytes:
    """(H, W) of 0/1 as X11 bitmap text: LSB first hex bytes, rows padded
    to a byte (PIL reads a set bit as white)."""
    bits = np.asarray(bits, np.uint8)
    H, W = bits.shape
    packed = np.packbits(bits, axis=1, bitorder="little").reshape(-1)
    out = b"#define %s_width %d\n#define %s_height %d\n" % (name, W, name, H)
    if hotspot:
        out += b"#define %s_x_hot %d\n#define %s_y_hot %d\n" % (name, hotspot[0], name, hotspot[1])
    out += b"static char %s_bits[] = {\n" % name
    hexes = [b"0x%02x" % v for v in packed]
    out += b",\n".join(sep.join(hexes[i:i + per_line]) for i in range(0, len(hexes), per_line))
    return out + b"};\n"


XPM_CHARS = bytes(range(35, 127)).replace(b'"', b"").replace(b"\\", b"")


def encode_xpm(indices, colours, cpp: int = 1, keys=None, pixels_comment: bool = True) -> bytes:
    """(H, W) indices into ``colours`` (an (r, g, b) or None for the
    transparent colour) as XPM text, ``cpp`` characters a pixel (``keys``:
    each colour's key, default from ``XPM_CHARS``)."""
    idx = np.asarray(indices)
    H, W = idx.shape
    if keys is None:
        keys = []
        for i in range(len(colours)):
            k, j = b"", i
            for _ in range(cpp):
                k += XPM_CHARS[j % len(XPM_CHARS):j % len(XPM_CHARS) + 1]
                j //= len(XPM_CHARS)
            keys.append(k)
    lines = [b"/* XPM */", b"static char *image[] = {", b"/* columns rows colors chars-per-pixel */",
             b'"%d %d %d %d ",' % (W, H, len(colours), cpp)]
    for k, c in zip(keys, colours):
        v = b"None" if c is None else b"#%02x%02x%02x" % tuple(int(x) for x in c)
        lines.append(b'"%s c %s",' % (k, v))
    if pixels_comment:
        lines.append(b"/* pixels */")
    for r in range(H):
        lines.append(b'"' + b"".join(keys[int(i)] for i in idx[r]) + b'",')
    return b"\n".join(lines) + b"\n};\n"


def encode_im(image_type: str, size, data: bytes, lut=None, extra=(), block: int = 512) -> bytes:
    """An IM file: the text header ("Image type", "Image size (x*y)", then
    ``extra`` lines) padded with zeros to ``block`` - 1 bytes and 0x1A, a
    768-byte ``lut`` where given, then ``data`` (rows bottom-up, as PIL
    reads them)."""
    lines = [f"Image type: {image_type} image", f"Image size (x*y): {size[0]}*{size[1]}",
             *extra]
    if lut is not None:
        lines.append("Lut: 1")
    head = "".join(f"{ln}\r\n" for ln in lines).encode("latin-1")
    head += b"\0" * max(0, block - 1 - len(head)) + b"\x1a"
    return head + (bytes(np.asarray(lut, np.uint8)) if lut is not None else b"") + data


def encode_imt(u8, comment: bytes = b"") -> bytes:
    """(H, W) uint8 as an IM Tools file: width, height and ``pixel n8`` lines,
    an optional ``*`` comment, form feed, the samples."""
    H, W = u8.shape
    return (b"width %d\nheight %d\n" % (W, H) + (b"*" + comment + b"\n" if comment else b"")
            + b"pixel n8\n\x0c" + np.ascontiguousarray(u8, np.uint8).tobytes())


def iptc_field(record: int, tag: int, data: bytes, extended: bool = False) -> bytes:
    """One IPTC/NAA dataset: 0x1C, record, tag, a 16-bit length (or, with
    ``extended``, 0x8004 and a 4-byte length), the data."""
    if extended:
        return bytes([0x1C, record, tag, 0x80, 0x04]) + struct.pack(">I", len(data)) + data
    return bytes([0x1C, record, tag]) + struct.pack(">H", len(data)) + data


def encode_iptc(w: int, h: int, payload: bytes, layers: int = 1, component: int = 0,
                band=None, compression: int = 1, chunk: int = 30000) -> bytes:
    """An IPTC/NAA image: record 3's layers and component (60), width (20),
    height (30), band (65, 1-based) and compression (120: 1 raw, 5 JPEG),
    then the (8, 10) data fields ``chunk`` bytes each (raw: the samples
    without their P5 header; JPEG: the stream)."""
    out = iptc_field(3, 60, bytes([layers, component])) + iptc_field(3, 20, struct.pack(">H", w))
    out += iptc_field(3, 30, struct.pack(">H", h))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    out += iptc_field(3, 120, bytes([compression]))
    for i in range(0, max(1, len(payload)), chunk):
        out += iptc_field(8, 10, payload[i:i + chunk], extended=chunk > 32767)
    return out


def encode_spider(img, big: bool = True, stack: int = 0) -> bytes:
    """(H, W) float32 as SPIDER: a header of labrec records of W · 4 bytes
    (nslice 1, nrow, iform 1, nsam, labrec, labbyt, lenbyt), the samples;
    with ``stack`` > 0, a stack header (istack, maxim) and the first image's
    own header before its samples."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    lenbyt = W * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(max(labbyt // 4, 27), np.float64)
    hdr[0], hdr[1], hdr[2], hdr[4] = 1, H, H, 1
    hdr[11], hdr[12], hdr[21], hdr[22] = W, labrec, labbyt, lenbyt
    dt = ">f4" if big else "<f4"
    if stack:
        top = hdr.copy()
        top[23], top[25] = 2, stack  # istack, maxim
        own = hdr.copy()
        own[26] = 1  # imgnum
        return (top.astype(dt).tobytes()[:labbyt] + own.astype(dt).tobytes()[:labbyt]
                + img.astype(dt).tobytes())
    return hdr.astype(dt).tobytes()[:labbyt] + img.astype(dt).tobytes()


def encode_gbr(pixels, version: int = 2, name: bytes = b"brush", spacing: int = 10) -> bytes:
    """(H, W) uint8 (depth 1) or (H, W, 4) RGBA (depth 4) as a GIMP brush,
    version 1 or 2 ("GIMP" magic and spacing), the name NUL-terminated."""
    px = np.asarray(pixels, np.uint8)
    H, W = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    size = (20 if version == 1 else 28) + len(name) + 1
    head = struct.pack(">IIIII", size, version, W, H, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + name + b"\0" + px.tobytes()


def encode_mcidas(pixels, bytes_per: int = 1, prefix: int = 0, bands: int = 1) -> bytes:
    """(H, W) as a McIDAS area: the 256-byte directory (w[1..64] as PIL
    numbers them: w[2] 4, w[9] lines, w[10] elements, w[11] bytes per
    element, w[14] bands, w[15] the row prefix, w[34] the data's offset),
    then rows of ``prefix`` zero bytes and ``bands`` × W big-endian
    samples (band 0 holds the pixels)."""
    px = np.asarray(pixels)
    H, W = px.shape
    w = [0] * 65
    w[2], w[9], w[10], w[11], w[14], w[15], w[34] = 4, H, W, bytes_per, bands, prefix, 256
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[bytes_per]
    rows = b""
    for r in px:
        samples = np.zeros((bands, W), dt)
        samples[0] = r
        rows += bytes(prefix) + samples.tobytes()
    return struct.pack(">64i", *w[1:]) + rows


def encode_pixar(rgb, channels: int = 14, depth: int = 2) -> bytes:
    """(H, W, 3) uint8 as a PIXAR raster: the magic, H at 416, W at 418, the
    channel and depth words (14, 2: RGB), samples from 1024."""
    rgb = np.asarray(rgb, np.uint8)
    H, W = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, H, W)
    struct.pack_into("<HH", head, 424, channels, depth)
    return bytes(head) + rgb.tobytes()


def encode_xvthumb(indices, comments=(b"#XVVERSION:Version 2.28",)) -> bytes:
    """(H, W) 3-3-2 palette indices as an XV thumbnail: "P7 332", comment
    lines to "#END_OF_COMMENTS", "W H 255", the indices."""
    idx = np.asarray(indices, np.uint8)
    H, W = idx.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments) + b"#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (W, H) + idx.tobytes())


def fits_cards(cards) -> bytes:
    """80-byte header cards ("KEY = value" or "END"), padded to 2880 bytes."""
    out = b""
    for c in cards:
        if isinstance(c, tuple):
            k, v = c
            out += (k.encode().ljust(8) + b"= " + v.encode().rjust(20)).ljust(80)
        else:
            out += c.encode().ljust(80)
    return out.ljust(-(-len(out) // 2880) * 2880)


def encode_fits(img, bitpix: int = 8, naxis: int = 2, gzip_tile: bool = False,
                gzip_members: int = 1, pad: bool = True) -> bytes:
    """(H, W) as a FITS primary array (big-endian samples, rows bottom-up as
    FITS stores them) of BITPIX 8, 16, 32, -32 or -64; ``naxis`` 1 stores
    one row; without ``pad`` the data is not padded to 2880 bytes. With ``gzip_tile``, a primary header without data and a
    BINTABLE extension holding ``ZIMAGE``/``ZCMPTYPE 'GZIP_1'`` whose heap is
    gzip of 4-byte big-endian words (in ``gzip_members`` members)."""
    import gzip as gz

    a = np.asarray(img)
    H, W = a.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if not gzip_tile:
        dims = [("NAXIS", "1"), ("NAXIS1", str(H * W))] if naxis == 1 else \
            [("NAXIS", "2"), ("NAXIS1", str(W)), ("NAXIS2", str(H))]
        head = fits_cards([("SIMPLE", "T"), ("BITPIX", str(bitpix)), *dims, "END"])
        data = a.astype(dt).tobytes()
        return head + data + (bytes(-len(data) % 2880) if pad else b"")
    words = a.astype(">i4").tobytes()
    cut = np.linspace(0, len(words), gzip_members + 1).astype(int)
    heap = b"".join(gz.compress(words[x:y], mtime=0) for x, y in zip(cut[:-1], cut[1:]))
    prim = fits_cards([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0"), "END"])
    ext = fits_cards([("XTENSION", "'BINTABLE'"), ("BITPIX", "8"), ("NAXIS", "2"),
                      ("NAXIS1", "8"), ("NAXIS2", "1"), ("ZIMAGE", "T"),
                      ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", str(bitpix)), ("ZNAXIS", "2"),
                      ("ZNAXIS1", str(W)), ("ZNAXIS2", str(H)), "END"])
    return prim + ext + bytes(8) + heap


def fli_chunk(kind: int, body: bytes) -> bytes:
    """One FLI subchunk: its size (6 + body), type, body."""
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_palette(pal, shift: int = 0, packets=None) -> bytes:
    """COLOR_256 (shift 0) or COLOR_64 (shift 2) body: ``packets`` of (skip,
    entries), default one packet of all 256 entries (count byte 0)."""
    pal = np.asarray(pal, np.uint8) >> shift
    if packets is None:
        return struct.pack("<HBB", 1, 0, 0) + pal[:256].tobytes()
    out, i = struct.pack("<H", len(packets)), 0
    for skip, count in packets:
        i += skip
        out += bytes([skip, count % 256]) + pal[i:i + (count or 256)].tobytes()
        i += count or 256
    return out


def fli_brun(idx) -> bytes:
    """BRUN body: each line a packet count byte (ignored by PIL), runs of a
    repeated index (count, value) and literals (-count, values)."""
    out = bytearray()
    for r in np.asarray(idx, np.uint8):
        line, x, W = bytearray(), 0, len(r)
        packets = 0
        while x < W:
            j = x
            while j < W and r[j] == r[x] and j - x < 127:
                j += 1
            if j - x >= 2:
                line += bytes([j - x, r[x]])
                x = j
            else:
                k = x
                while k < W and k - x < 128 and not (k + 1 < W and r[k] == r[k + 1]):
                    k += 1
                k = max(k, x + 1)
                line += bytes([256 - (k - x)]) + bytes(r[x:k])
                x = k
            packets += 1
        out += bytes([packets & 255]) + line
    return bytes(out)


def fli_lc(idx, prev) -> bytes:
    """LC (byte delta) body against ``prev``: the first changed line, the
    line count, then per line packets of (skip, count, bytes)."""
    idx, prev = np.asarray(idx, np.uint8), np.asarray(prev, np.uint8)
    rows = np.nonzero((idx != prev).any(1))[0]
    if not len(rows):
        return struct.pack("<HH", 0, 0)
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        diff = np.nonzero(idx[y] != prev[y])[0]
        packets, x = [], 0
        i = 0
        while i < len(diff):
            start = int(diff[i])
            end = start + 1
            while i + 1 < len(diff) and diff[i + 1] - end < 4 and diff[i + 1] + 1 - start <= 127:
                i += 1
                end = int(diff[i]) + 1
            while start - x > 255:
                packets.append(bytes([255, 0]))
                x += 255
            packets.append(bytes([start - x, end - start]) + bytes(idx[y, start:end]))
            x = end
            i += 1
        out += bytes([len(packets)]) + b"".join(packets)
    return bytes(out)


def fli_ss2(idx, prev) -> bytes:
    """SS2 (word delta) body against ``prev`` for an even width: the line
    count, per line a skip word for unchanged lines before it and a packet
    count, packets of (skip, word count, words)."""
    idx, prev = np.asarray(idx, np.uint8), np.asarray(prev, np.uint8)
    H, W = idx.shape
    lines, out, skip = 0, bytearray(), 0
    for y in range(H):
        if (idx[y] == prev[y]).all():
            skip += 1
            continue
        words = idx[y].reshape(-1, 2)
        diff = np.nonzero((words != prev[y].reshape(-1, 2)).any(1))[0]
        packets, x = [], 0
        for w0 in diff:
            w0 = int(w0)
            while 2 * w0 - x > 255:
                packets.append(bytes([255, 0]))
                x += 255
            packets.append(bytes([2 * w0 - x, 1]) + bytes(words[w0]))
            x = 2 * w0 + 2
        if skip:
            out += struct.pack("<H", (65536 - skip) & 0xFFFF)
            skip = 0
        out += struct.pack("<H", len(packets)) + b"".join(packets)
        lines += 1
    return struct.pack("<H", lines) + bytes(out)


def encode_fli(idx, pal, kind: int = 0xAF12, chunks=None, frames: int = 1,
               prefix: bytes = b"") -> bytes:
    """(H, W) palette indices as an FLI (0xAF11) or FLC (0xAF12) animation
    of one frame: ``chunks`` (default a COLOR_256 palette and a BRUN of the
    indices) inside an 0xF1FA frame at 128, after an optional 0xF100
    ``prefix`` chunk body (FLC)."""
    idx = np.asarray(idx, np.uint8)
    H, W = idx.shape
    if chunks is None:
        chunks = [fli_chunk(4, fli_palette(pal)), fli_chunk(15, fli_brun(idx))]
    body = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body
    pre = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix if prefix else b""
    size = 128 + len(pre) + len(frame)
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, size, kind, frames, W, H, 8, 0, 5)
    return bytes(head) + pre + frame


def encode_pcd(y, cb, cr, orientation: int = 0) -> bytes:
    """A Kodak PhotoCD base image: (512, 768) luma and (256, 384) Cb, Cr as
    PIL's decoder takes them (at 96 · 2048, chunks of two luma rows and one
    chroma row each), "PCD_" at 2048 and the orientation in byte 3586's low
    bits."""
    y, cb, cr = (np.asarray(a, np.uint8) for a in (y, cb, cr))
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation & 3
    chunks = np.concatenate([y.reshape(256, 2 * 768), cb, cr], axis=1)
    return bytes(head) + chunks.tobytes()


def pcd_sample(seed: int, orientation: int = 0) -> bytes:
    """A PhotoCD file from a seed: the scene as luma with noise, chroma
    uniform in 60..199, in ``orientation``."""
    rng = np.random.default_rng(seed)
    y = np.clip(scene(512, 768, seed).astype(np.int64) + rng.integers(-20, 20, (512, 768)), 0, 255)
    return encode_pcd(y, rng.integers(60, 200, (256, 384)), rng.integers(60, 200, (256, 384)),
                      orientation)


def layout_files(seed: int) -> dict:
    """The fixtures of the raw-layout plugins (each under 4 KB; PCD's base
    image is 786 KB, so it has none): an MSP of each kind, an XBM with a hot
    spot, an XPM of 2 characters a pixel with a transparent colour, an IM of
    L and one of a colour Lut, an IMT, an IPTC of raw data and one of a
    JPEG's band, a little-endian SPIDER, a GBR version 2 RGBA brush, a
    McIDAS of 2-byte samples with a row prefix, a PIXAR, an XV thumbnail,
    FITS of BITPIX 8, 16 and -32 (their data unpadded) and a GZIP_1 tile
    (two header blocks: 6.9 KB), an FLC of BRUN and an
    FLI of COPY then an LC delta."""
    from PIL import Image

    h, w = 24, 32
    g = scene(h, w, seed + 50)
    rgb = scene(h, w, seed + 51, 3)
    rng = np.random.default_rng(seed + 52)
    bits = (g > 120).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3))
    idx = (g // 32).astype(np.uint8)
    colours = [tuple(int(v) for v in c) for c in rng.integers(0, 256, (8, 3))]
    colours[3] = None  # transparent, and so used by no pixel (PIL: not in the palette)
    idx_xpm = np.where(idx == 3, 2, idx)
    jpeg = _pil_save(Image.fromarray(g), "JPEG", quality=85)
    delta = g.copy()
    delta[5:11, 7:20] = 255 - delta[5:11, 7:20]
    ramp = np.stack([np.arange(256)] * 3, 1)
    return {
        "msp_danm.msp": (encode_msp(bits), "MSP DanM, raw bits"),
        "msp_lins.msp": (encode_msp(bits, b"LinS"), "MSP LinS, RLE rows"),
        "xbm_hotspot.xbm": (encode_xbm(bits, hotspot=(3, 4)), "XBM with a hot spot"),
        "xpm_2cpp.xpm": (encode_xpm(idx_xpm, colours, 2), "XPM, 2 characters a pixel, None"),
        "im_l.im": (encode_im("Greyscale", (w, h), g[::-1].tobytes()), "IM, L, bottom-up"),
        "im_lut.im": (encode_im("Greyscale", (w, h), idx[::-1].tobytes(), lut=rng.integers(
            0, 256, 768)), "IM, L with a colour Lut (P)"),
        "imt.imt": (encode_imt(g), "IM Tools, 8-bit"),
        "iptc_raw.iim": (encode_iptc(w, h, g.tobytes()), "IPTC/NAA, raw L"),
        "iptc_jpeg_band.iim": (encode_iptc(w, h, jpeg, 3, 1, 2, 5),
                               "IPTC/NAA, a gray JPEG as band G of RGB"),
        "spider_le.spi": (encode_spider(g[:, :20].astype(np.float32) * 1.5 - 20, big=False),
                          "SPIDER, little-endian, 20 wide"),
        "gbr_rgba.gbr": (encode_gbr(np.dstack([rgb[:16, :16], g[:16, :16]])),
                         "GBR version 2, RGBA, 16×16"),
        "mcidas_16.area": (encode_mcidas(g.astype(np.int64) * 2, 2, prefix=4),
                           "McIDAS area, 2-byte samples, a 4-byte row prefix"),
        "pixar.pxr": (encode_pixar(rgb[:8, :12]), "PIXAR, RGB, 12×8"),
        "xvthumb.xv": (encode_xvthumb(g), "XV thumbnail, 3-3-2 palette"),
        "fits_8.fits": (encode_fits(g[:20, :20], 8, pad=False), "FITS, BITPIX 8"),
        "fits_16.fits": (encode_fits(g[:16, :16].astype(np.int64) * 3 - 100, 16, pad=False),
                         "FITS, BITPIX 16 (PIL reads it little-endian)"),
        "fits_float.fits": (encode_fits(g[:12, :12].astype(np.float64) / 2, -32, pad=False),
                            "FITS, BITPIX -32"),
        "fits_gzip.fits": (encode_fits(g.astype(np.int64) * 4, 16, gzip_tile=True),
                           "FITS, BINTABLE GZIP_1 tile, ZBITPIX 16"),
        "flc_brun.flc": (encode_fli(g, ramp), "FLC, COLOR_256 grey ramp, BRUN"),
        "fli_lc.fli": (encode_fli(delta, pal, kind=0xAF11, chunks=[
            fli_chunk(11, fli_palette(pal, 2)), fli_chunk(16, g.tobytes()),
            fli_chunk(12, fli_lc(delta, g))]), "FLI, COLOR_64, COPY then an LC delta"),
    }


def raster_files(seed: int) -> dict:
    """The QOI, Sun raster, PCX, SGI, TGA, ICO, CUR, DIB and DDS fixtures:
    the seven files these formats had while the port refused them (the same
    bytes), and a headerless DIB, TGA files (RLE, colour-mapped, flipped),
    BC7 and BC6H DDS files, and a CUR and an ICO of DIB entries from the
    encoders above."""
    from PIL import Image

    h, w = 24, 32
    g = scene(h, w, seed + 30)
    rgb = scene(h, w, seed + 31, 3)
    im, imc = Image.fromarray(g), Image.fromarray(rgb)
    rng = np.random.default_rng(seed + 40)
    cur_px = np.dstack([rgb[:16, :16, ::-1], np.full((16, 16, 1), 255, np.uint8)])[::-1]
    cur = (struct.pack("<HHH", 0, 2, 1) + struct.pack("<BBBBHHII", 16, 16, 0, 0, 1, 1,
                                                      40 + 16 * 16 * 4 + 16 * 4, 22)
           + struct.pack("<IiiHHIIiiII", 40, 16, 32, 1, 32, 0, 0, 0, 0, 0, 0)
           + cur_px.tobytes() + bytes(16 * 4))
    sun = struct.pack(">8I", 0x59A66A95, w, h, 8, w * h, 1, 0, 0) + g.tobytes()
    rgba = np.dstack([rgb, g])
    pal = rng.integers(0, 256, (16, 3))
    idx = (g // 16).astype(np.uint8)
    bc6 = rng.integers(0, 256, (((w + 3) // 4) * ((h + 3) // 4), 16)).astype(np.uint8)
    bc6[:, 0] = (bc6[:, 0] & 0xE0) | np.array([3, 7, 11, 15, 0, 1, 2])[
        rng.integers(0, 7, len(bc6))]  # modes 11-14 and three two-region modes
    return {
        "ico.ico": (_pil_save(imc, "ICO", sizes=[(16, 16)]), "ICO, a PNG entry (PIL)"),
        "cur.cur": (cur, "CUR, 16×16 32-bit"),
        "qoi.qoi": (_pil_save(imc, "QOI"), "QOI (PIL)"),
        "dds.dds": (_pil_save(imc, "DDS"), "DDS (PIL)"),
        "sgi.sgi": (_pil_save(im, "SGI"), "SGI (PIL)"),
        "sun.ras": (sun, "Sun raster, 8-bit"),
        "pcx.pcx": (_pil_save(im, "PCX"), "PCX (PIL)"),
        "dib_8bit.dib": (encode_dib(idx, 8, palette=pal), "headerless DIB, 8-bit palette"),
        "dib_os2_24bit.dib": (encode_dib(rgb[:9, :13], 24, header=12),
                              "headerless DIB, OS/2 12-byte header, 24-bit"),
        "tga_rle_gray.tga": (encode_tga(g, 11, 8), "TGA, RLE gray, bottom-up"),
        "tga_cmap16.tga": (encode_tga(idx + 2, 1, 8, cmap=pal, cmap_depth=16, cmap_start=2,
                                      ident=b"id"),
                           "TGA, colour-mapped, 16-bit map from index 2, an ID field"),
        "tga_rle_rgb_flip.tga": (encode_tga(rgb, 10, 24, top_down=True, flip=True),
                                 "TGA, RLE 24-bit, top-down, flipped left to right"),
        "tga_rle_cmap24.tga": (encode_tga(idx, 9, 8, cmap=pal, cmap_depth=24),
                               "TGA, RLE colour-mapped, 24-bit map"),
        "dds_bc7.dds": (encode_dds(bc7_blocks(rgba[:h - 1, :w - 3]), w - 3, h - 1,
                                   fourcc=b"DX10", dxgi=98),
                        "DDS, BC7 (mode 6), 29×23"),
        "dds_bc6h.dds": (encode_dds(bc6.tobytes(), w, h, fourcc=b"DX10", dxgi=95),
                         "DDS, BC6H UF16, random blocks of seven modes"),
        "dds_bc1.dds": (encode_dds(bc1_blocks(rgb[:h - 2, :w - 1]), w - 1, h - 2),
                        "DDS, DXT1, 31×22"),
        "cur_dib8.cur": (encode_ico([ico_dib(idx[:12, :10], 8, palette=pal)], kind=2),
                         "CUR, an 8-bit palette DIB entry"),
        "ico_dib.ico": (encode_ico([ico_dib(idx[:8, :8], 4, palette=pal),
                                    ico_dib(rgb[:12, :12], 24)]),
                        "ICO, 4-bit and 24-bit DIB entries with AND masks"),
    }


def strip_dht(data: bytes) -> bytes:
    """A JPEG's bytes without its DHT segments (as motion-JPEG frames come:
    decoders use the standard tables of ITU T.81 K.3)."""
    out, p = bytearray(data[:2]), 2
    while p < len(data):
        m = data[p + 1]
        if m == 0xDA:
            return bytes(out + data[p:])
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if m != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n
    return bytes(out)


def _rgb_to_ycc(rgb):
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255)


def _cmyk_to_ycck(cmyk):
    """The inverse of libjpeg's YCCK → CMYK under PIL's inversion of
    Adobe CMYK: the file's first three components are YCbCr of PIL's
    (C, M, Y) read as RGB, the fourth is 255 - K."""
    ycc = _rgb_to_ycc(cmyk[..., :3].astype(np.float64))
    return np.concatenate([ycc, 255 - cmyk[..., 3:].astype(np.float64)], -1)


SEQ_FRAMES = 6
SEQ_DIR = "seq_prog"
BASELINE_DIR = "seq_baseline"  # the sequence's first pair as baseline JPEGs (decode timing)
WEBP_DIR = "seq_webp"  # the sequence's first pair as lossy WebPs, quality 90 (decode timing)
ZSTD_DIR = "seq_zstd"  # the sequence's first pair as ZSTD TIFFs (decode timing: no zstd on the card)
SEQ_NS0 = 1_403_636_579_763_555_584


def zstd_pair_files(pair) -> dict:
    """The sequence's first rendered pair (two 8-bit frames) as ZSTD TIFFs:
    libzstd level 3, predictor 2, 16-row strips."""
    return {f"{ZSTD_DIR}/{cam_dir}.tif": (
        encode_tiff(np.asarray(u8), compression=50000, predictor=2, rows_per_strip=16),
        "gray, ZSTD level 3 (libzstd), predictor 2, 16-row strips, 752×480")
        for cam_dir, u8 in zip(("cam0", "cam1"), pair)}


def first_pair() -> list:
    """The sequence's first pair as ``sequence_files`` renders it (uint8)."""
    world, cam, traj = _sequence_scene()
    pair = _render_pair(world, cam, traj[0], 0)
    return pair


def _sequence_scene():
    sys.path.insert(0, os.path.dirname(HERE))
    from rspl_slam_tpu_torch.config import SystemConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    cam = SystemConfig().camera
    world = synthetic.make_scene(num_points=600, num_lines=12, seed=1, extent=(6.0, 4.0, 6.0),
                                 on_line_frac=0.0)
    traj = synthetic.make_trajectory(30, step=0.05)[:SEQ_FRAMES]
    return world, cam, traj


def _render_pair(world, cam, pose, seed: int) -> list:
    from rspl_slam_tpu_torch.evaluation import synthetic

    return [(np.clip(im, 0, 1) * 255).astype(np.uint8)
            for im in synthetic.render_images(world, cam, pose, seed=seed)]


def sequence_files() -> dict:
    """The full-width progressive stereo sequence as a raw-EuRoC tree: the
    first ``SEQ_FRAMES`` pairs of the smoke's lines scene (the port's
    renderer, EuRoC's 752×480 camera) written by PIL as progressive JPEGs,
    ``cam0/data.csv`` and the ground truth (``INIT_POSE`` times the
    rendered camera poses, as ``chip_smoke._write_tree`` writes it); and
    the first pair again as baseline JPEGs under ``BASELINE_DIR`` and as
    lossy WebPs at quality 90 under ``WEBP_DIR`` and as ZSTD TIFFs under
    ``ZSTD_DIR``."""
    from PIL import Image

    world, cam, traj = _sequence_scene()
    from rspl_slam_tpu_torch.slam import INIT_POSE

    names = [SEQ_NS0 + i * 50_000_000 for i in range(SEQ_FRAMES)]
    seq = f"{SEQ_DIR}/mav0"
    files = {}
    for i, ns in enumerate(names):
        pair = _render_pair(world, cam, traj[i], i)
        if i == 0:
            files.update(zstd_pair_files(pair))
        for cam_dir, im in zip(("cam0", "cam1"), pair):
            u8 = Image.fromarray(im)
            buf = io.BytesIO()
            u8.save(buf, "JPEG", quality=85, progressive=True)
            files[f"{seq}/{cam_dir}/data/{ns}.jpg"] = (buf.getvalue(),
                                                        "progressive gray (PIL), 752×480")
            if i == 0:
                buf = io.BytesIO()
                u8.save(buf, "JPEG", quality=85)
                files[f"{BASELINE_DIR}/{cam_dir}.jpg"] = (buf.getvalue(),
                                                           "baseline gray (PIL), 752×480")
                buf = io.BytesIO()
                u8.save(buf, "WEBP", quality=90)
                files[f"{WEBP_DIR}/{cam_dir}.webp"] = (buf.getvalue(),
                                                        "lossy gray, quality 90 (PIL), 752×480")
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    text = {f"{seq}/cam0/data.csv": "#timestamp [ns],filename\n"
            + "".join(f"{ns},{ns}.jpg\n" for ns in names),
            f"{seq}/state_groundtruth_estimate0/data.csv":
            "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n"
            + "".join(f"{ns},{float(T[0, 3])!r},{float(T[1, 3])!r},{float(T[2, 3])!r}\n"
                      for ns, T in zip(names, gt))}
    return files, text


def write_all(out: str, seed: int) -> dict:
    files = small_files(seed)
    seq, text = sequence_files()
    files.update(seq)
    manifest = {"seed": seed, "files": {}}
    for name, (data, kind, *extra) in sorted(files.items()):
        path = os.path.join(out, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        entry = {"kind": kind, **(extra[0] if extra else {})}
        stem = os.path.splitext(os.path.basename(name))[0]
        if stem in REFUSED:
            entry.update(refused=True, refusal=REFUSED[stem])
        if not entry.get("refused"):
            entry["sha256"] = pil_sha256(path)
        manifest["files"][name] = entry
    for name, body in text.items():
        os.makedirs(os.path.dirname(os.path.join(out, name)), exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            f.write(body)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    m = write_all(args.out, args.seed)
    print(f"wrote {len(m['files'])} files to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
