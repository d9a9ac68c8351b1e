"""Single-bit flips inside the IFD of random LZMA and ZSTD TIFFs, held to
PIL: how many files the port reads otherwise than PIL 12.1 (libtiff
4.7.1), by the IFD entry's tag and the field the flip hit. The corpora of
``test_torch_tiff_compressions.py`` damage the image data only; this
measures ROADMAP §3's open item on damaged IFDs.

    python tests/torch_tiff_ifd_probe.py [--seed N] [--files N] [--flips N]

Prints one JSON line: the files, the disagreements, and their classes
("tag field pil-outcome": count).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--files", type=int, default=20, help="files of each compression")
    ap.add_argument("--flips", type=int, default=40, help="flipped copies of each file")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    warnings.simplefilter("ignore")
    import pathlib

    import test_torch_tiff_compressions as T

    rng = np.random.default_rng(args.seed)
    files = (T._files(rng, 34925, [T._xz_preset], args.files, 0)
             + T._files(rng, 50000, [T._zstd_level], args.files, 0))
    classes, total, faults = collections.Counter(), 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "f.tif"
        for _, data in files:
            ifd = T._ifd_at(data)
            e = "<" if data[:2] == b"II" else ">"
            n = struct.unpack(e + "H", data[ifd:ifd + 2])[0]
            for _ in range(args.flips):
                d = bytearray(data)
                i = int(rng.integers(ifd, len(d)))
                d[i] ^= 1 << int(rng.integers(8))
                total += 1
                r = T._agrees(bytes(d), path)
                if not r:
                    continue
                faults += 1
                k = i - ifd - 2
                pil = "pil-reads" if "PIL reads" in r else "pil-fails"
                if 0 <= k < 12 * n:
                    tag = struct.unpack(e + "H", data[ifd + 2 + 12 * (k // 12):
                                                      ifd + 4 + 12 * (k // 12)])[0]
                    field = ("tag", "tag", "type", "type", "count", "count", "count", "count",
                             "value", "value", "value", "value")[k % 12]
                    classes[f"{tag} {field} {pil}"] += 1
                else:
                    classes[f"{'entry count' if k < 0 else 'past the entries'} {pil}"] += 1
    print(json.dumps({"files": total, "disagreements": faults,
                      "classes": dict(classes.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
