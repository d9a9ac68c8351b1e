"""Single-bit flips inside the IFD of random LZMA, ZSTD, raw, PackBits,
LZW and Deflate TIFFs, held to PIL: how many files the port reads
otherwise than PIL 12.1 (libtiff 4.7.1), by the IFD entry's tag and the
field the flip hit. The corpora of ``test_torch_tiff_compressions.py``
damage the image data only; this measures damaged IFDs (ROADMAP §3).

    python tests/torch_tiff_ifd_probe.py [--seed N] [--files N] [--flips N]
        [--compressions lzma,zstd,raw,packbits,lzw,deflate]

Prints one JSON line: the files, the disagreements, their classes
("tag field pil-outcome": count), and the disagreements by compression.
The LZMA and ZSTD files and their flips are drawn first from the seed's
generator, as they were when the probe covered only those two; the other
compressions draw from a generator of their own.
"""

import argparse
import collections
import json
import os
import struct
import sys
import tempfile
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.dirname(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
COMPRESSIONS = {"lzma": 34925, "zstd": 50000, "raw": 1, "packbits": 32773, "lzw": 5,
                "deflate": 8}


def corpus(seed: int, files: int = 20, flips: int = 40):
    """The probe's files: (compression, file index, flip index, the file,
    the flipped byte's offset, the flipped copy) for every flip."""
    import test_torch_tiff_compressions as T

    rng = np.random.default_rng(seed)
    first = (T._files(rng, 34925, [T._xz_preset], files, 0)
             + T._files(rng, 50000, [T._zstd_level], files, 0))
    runs = [(rng, [("lzma" if i < files else "zstd", i % files, d)
                   for i, (_, d) in enumerate(first)])]
    rest = np.random.default_rng([seed, 1])
    runs.append((rest, [(c, i, d) for c in ("raw", "packbits", "lzw", "deflate")
                        for i, (_, d) in enumerate(T._files(rest, COMPRESSIONS[c], [None],
                                                            files, 0))]))
    for gen, group in runs:
        for kind, i, data in group:
            ifd = T._ifd_at(data)
            for j in range(flips):
                d = bytearray(data)
                at = int(gen.integers(ifd, len(d)))
                d[at] ^= 1 << int(gen.integers(8))
                yield kind, i, j, data, at, bytes(d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--files", type=int, default=20, help="files of each compression")
    ap.add_argument("--flips", type=int, default=40, help="flipped copies of each file")
    ap.add_argument("--compressions", default=",".join(COMPRESSIONS))
    ap.add_argument("--dump", help="write each disagreeing file into this directory")
    args = ap.parse_args(argv)
    warnings.simplefilter("ignore")
    import pathlib

    import test_torch_tiff_compressions as T

    wanted = args.compressions.split(",")
    classes, by_kind, total, faults = collections.Counter(), collections.Counter(), 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "f.tif"
        for kind, i, j, data, at, d in corpus(args.seed, args.files, args.flips):
            if kind not in wanted:
                continue
            total += 1
            r = T._agrees(d, path)
            if not r:
                continue
            faults += 1
            by_kind[kind] += 1
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                with open(os.path.join(args.dump, f"{kind}_{i}_{j}.tif"), "wb") as f:
                    f.write(d)
                print(f"{kind}_{i}_{j}.tif: byte {at - T._ifd_at(data)} of the IFD: {r}",
                      file=sys.stderr)
            ifd = T._ifd_at(data)
            e = "<" if data[:2] == b"II" else ">"
            n = struct.unpack(e + "H", data[ifd:ifd + 2])[0]
            k = at - ifd - 2
            pil = "pil-reads" if "PIL reads" in r else "pil-fails"
            if 0 <= k < 12 * n:
                tag = struct.unpack(e + "H", data[ifd + 2 + 12 * (k // 12):
                                                  ifd + 4 + 12 * (k // 12)])[0]
                field = ("tag", "tag", "type", "type", "count", "count", "count", "count",
                         "value", "value", "value", "value")[k % 12]
                classes[f"{kind} {tag} {field} {pil}"] += 1
            else:
                where = "entry count" if k < 0 else "past the entries"
                classes[f"{kind} {where} {pil}"] += 1
    print(json.dumps({"files": total, "disagreements": faults,
                      "by_compression": {c: by_kind[c] for c in wanted},
                      "classes": dict(classes.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
