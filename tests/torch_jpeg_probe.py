"""How the port's JPEG reader agrees with PIL 12.1 (libjpeg-turbo 3.1.3
behind Pillow) where a stream ends early or its scan is damaged: the
counts ROADMAP §3 records. Three probes, each over files PIL writes from
a seed:

- ``ends``: 64 baseline JPEGs (L, RGB, CMYK; 7 × 2 to 40 × 30) with EOI
  removed and 0-9 bytes appended: files whose read-or-raise outcome the
  port shares with PIL for every count of bytes;
- ``mutations``: 150 JPEGs (L, RGB, CMYK; baseline and progressive;
  restart intervals) and 6 copies of each with 1-3 flipped bits, cut short
  or lengthened: files where the port and PIL disagree, by kind;
- ``flips``: every single-bit flip in the scans of six 16 × 16 gray JPEGs
  that PIL still reads: files where the port gives PIL's pixels.

    python tests/torch_jpeg_probe.py [--repo PATH] [ends|mutations|flips ...]

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


def ends(native) -> dict:
    rng = np.random.default_rng(1)
    shapes = [("CMYK", (7, 2, 4)), ("L", (7, 2)), ("RGB", (7, 2, 3)), ("L", (10, 7)),
              ("L", (16, 16)), ("L", (8, 8)), ("RGB", (16, 16, 3)), ("RGB", (40, 30, 3))]
    agree = total = 0
    for mode, shape in shapes:
        for _ in range(8):
            sub = int(rng.integers(0, 3))
            j = _jpeg(rng.integers(0, 256, shape).astype(np.uint8), mode, quality=90,
                      subsampling=sub)
            files = [j[:-2] + bytes([1]) * k for k in range(10)]
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


def mutations(native) -> dict:
    rng = np.random.default_rng(0)
    kinds = collections.Counter()
    total = 0
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
        for d in [data] + [_mutate(rng, data) for _ in range(6)]:
            total += 1
            a, b = _pil(d), _port(native, d)
            if not _same(a, b):
                kinds[f"PIL {a[0]}, port {b[0]}"] += 1
    return {"files": total, "disagree": sum(kinds.values()), "by_kind": dict(kinds)}


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
    ap.add_argument("probes", nargs="*", default=["ends", "mutations", "flips"])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    from rspl_slam_tpu_torch import native

    for name in args.probes:
        print(name, {"ends": ends, "mutations": mutations, "flips": flips}[name](native),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
