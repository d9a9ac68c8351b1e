"""How the port's JPEG reader agrees with PIL 12.1 (libjpeg-turbo 3.1.3
behind Pillow) where a stream ends early or its scan is damaged: the
counts ROADMAP §3 records. Four probes, each over files made from a
seed:

- ``ends``: 64 baseline JPEGs (L, RGB, CMYK; 7 × 2 to 40 × 30) with EOI
  removed and 0-9 bytes appended: files whose read-or-raise outcome the
  port shares with PIL for every count of bytes (``ends_files``, ``cut``);
- ``mutations``: 150 JPEGs (L, RGB, CMYK; baseline and progressive;
  restart intervals) and 6 copies of each with 1-3 flipped bits, cut short
  or lengthened (``mutated_files``): files where the port and PIL disagree,
  by kind;
- ``flips``: every single-bit flip in the scans of six 16 × 16 gray JPEGs
  that PIL still reads: files where the port gives PIL's pixels;
- ``coded``: 40 JPEGs PIL cannot write (arithmetic, lossless, restart
  intervals) and 10 mutated copies of each: disagreements, by kind.

    python tests/torch_jpeg_probe.py [--repo PATH] [ends|mutations|flips|coded ...]

``--repo`` points at another checkout of the port (a parent commit, for
before-and-after counts). Needs PIL; runs on the CPU.
"""

import argparse
import collections
import io
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _pil(data):
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as im:
            return "ok", np.asarray(im.convert("L"))
    except UnidentifiedImageError:
        return "value", None
    except Exception:  # noqa: BLE001 - any other failure of PIL's
        return "error", None


def _port(native, data):
    try:
        return "ok", native.decode_u8(data)
    except NotImplementedError:
        return "refused", None
    except ValueError:
        return "value", None
    except OSError:
        return "error", None


def _same(a, b) -> bool:
    if a[0] == "ok" or b[0] == "ok":
        return a[0] == b[0] and a[1].shape == b[1].shape and bool((a[1] == b[1]).all())
    if a[0] == "value":
        return b[0] == "value"
    return b[0] in ("error", "refused")


def _jpeg(array, mode, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(array, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def ends_files() -> list:
    """The ``ends`` probe's 64 baseline JPEGs, whole: (mode, JPEG) each."""
    rng = np.random.default_rng(1)
    shapes = [("CMYK", (7, 2, 4)), ("L", (7, 2)), ("RGB", (7, 2, 3)), ("L", (10, 7)),
              ("L", (16, 16)), ("L", (8, 8)), ("RGB", (16, 16, 3)), ("RGB", (40, 30, 3))]
    out = []
    for mode, shape in shapes:
        for _ in range(8):
            sub = int(rng.integers(0, 3))
            out.append((mode, _jpeg(rng.integers(0, 256, shape).astype(np.uint8), mode,
                                    quality=90, subsampling=sub)))
    return out


def cut(jpeg: bytes, k: int) -> bytes:
    """A JPEG without its EOI and with k bytes of 0x01 after its data."""
    return jpeg[:-2] + bytes([1]) * k


def ends(native) -> dict:
    agree = total = 0
    for _, j in ends_files():
        files = [cut(j, k) for k in range(10)]
        total += 1
        agree += all(_pil(f)[0] == _port(native, f)[0] for f in files)
    return {"files": total, "every_length_agrees": agree}


def _mutate(rng, data: bytes) -> bytes:
    d = bytearray(data)
    r = rng.random()
    if r < 0.6 and d:
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(len(d)))
            d[i] ^= 1 << int(rng.integers(8))
    elif r < 0.8:
        d = d[:int(rng.integers(0, len(d) + 1))]
    else:
        i = int(rng.integers(len(d) + 1))
        d[i:i] = bytes(rng.integers(0, 256, int(rng.integers(1, 5))).astype(np.uint8))
    return bytes(d)


def mutated_files() -> list:
    """The ``mutations`` probe's 1,050 files in order: each of 150 JPEGs, then
    its six copies."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(150):
        H, W = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        mode = str(rng.choice(["L", "RGB", "CMYK"]))
        shape = (H, W) if mode == "L" else (H, W, 3 if mode == "RGB" else 4)
        a = rng.integers(0, 256, shape)
        if rng.random() < 0.5:
            a = np.repeat(a, 3, axis=1)[:, :W]
        data = _jpeg(a.astype(np.uint8), mode, quality=int(rng.integers(30, 100)),
                     progressive=bool(rng.random() < 0.4), subsampling=int(rng.integers(0, 3)),
                     restart_marker_blocks=int(rng.integers(0, 3)) if rng.random() < 0.2 else 0)
        out += [data] + [_mutate(rng, data) for _ in range(6)]
    return out


def mutations(native) -> dict:
    kinds = collections.Counter()
    files = mutated_files()
    for d in files:
        a, b = _pil(d), _port(native, d)
        if not _same(a, b):
            kinds[f"PIL {a[0]}, port {b[0]}"] += 1
    return {"files": len(files), "disagree": sum(kinds.values()), "by_kind": dict(kinds)}


def coded_files() -> list:
    """The ``coded`` probe's files: 40 JPEGs of ``torch_make_image_kinds``'s
    encoder that PIL cannot write (arithmetic sequential with restarts,
    arithmetic progressive, lossless at each predictor with restarts of
    whole rows, Huffman with restarts; gray, 1-29 × 1-29), each then 10
    mutated copies."""
    sys.path.insert(0, HERE)
    import torch_make_image_kinds as mk

    rng = np.random.default_rng(11)
    out = []
    for i in range(40):
        H, W = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        g = mk.scene(H, W, i)
        kind = i % 4
        if kind == 0:
            data = mk.encode_jpeg([g], arith=True, restart=int(rng.integers(0, 3)))
        elif kind == 1:
            data = mk.encode_jpeg([g], mode="progressive", arith=True)
        elif kind == 2:
            data = mk.encode_jpeg([g], mode="lossless", predictor=int(rng.integers(1, 8)),
                                  restart=int(rng.integers(0, 3)) * W)
        else:
            data = mk.encode_jpeg([g], restart=int(rng.integers(1, 4)))
        out += [(("arithmetic", "arithmetic progressive", "lossless", "restarts")[kind], d)
                for d in [data] + [_mutate(rng, data) for _ in range(10)]]
    return out


def coded(native) -> dict:
    kinds = collections.Counter()
    files = coded_files()
    for kind, d in files:
        a, b = _pil(d), _port(native, d)
        if not _same(a, b):
            kinds[f"{kind}: PIL {a[0]}, port {b[0]}"] += 1
    return {"files": len(files), "disagree": sum(kinds.values()), "by_kind": dict(kinds)}


def flips(native) -> dict:
    sys.path.insert(0, HERE)
    import torch_make_image_kinds as mk

    read = agree = 0
    for seed in range(3):
        for q in (100, 95):
            base = _jpeg(mk.scene(16, 16, seed), "L", quality=q)
            sos = base.index(b"\xff\xda")
            start = sos + 2 + struct.unpack(">H", base[sos + 2:sos + 4])[0]
            for pos in range(start, len(base) - 2):
                for bit in range(8):
                    d = bytearray(base)
                    d[pos] ^= 1 << bit
                    a = _pil(bytes(d))
                    if a[0] != "ok":
                        continue
                    read += 1
                    agree += _same(a, _port(native, bytes(d)))
    return {"pil_reads": read, "port_agrees": agree}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(HERE))
    ap.add_argument("probes", nargs="*", default=["ends", "mutations", "flips", "coded"])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    from rspl_slam_tpu_torch import native

    for name in args.probes:
        print(name, {"ends": ends, "mutations": mutations, "flips": flips,
                     "coded": coded}[name](native),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
