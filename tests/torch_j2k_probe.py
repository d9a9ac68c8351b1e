"""Where the port's JPEG 2000 reader and PIL 12.1 could part, asks OpenJPEG
2.5.4 itself: Pillow's bundled libopenjp2, driven through ctypes the way
Pillow's Jpeg2KDecode.c drives it (opj_read_header, then
opj_read_tile_header and opj_decode_tile_data per tile, then
opj_end_decompress), with its error, warning and info messages kept. Two
probes:

- ``file PATH ...``: OpenJPEG's outcome for each file (the image's colour
  space, components and tiles, the step that failed and its messages),
  beside PIL's and the port's;
- ``corpus``: the seeded corpus of ``test_torch_jpeg2000.py`` and its
  damaged copies (``--seeds``, ``--draws``, ``--copies``): every file the
  port reads otherwise than PIL, with OpenJPEG's first error message,
  counted by it (the message names the check the port must mirror);
- ``time PATH ...``: the port's decode of each file by
  ``native.decode_gray``, ms a frame (the mean of ``--reps`` after one
  warm-up call), on this machine's CPU.

    python tests/torch_j2k_probe.py [--repo PATH] file a.j2k b.jp2
    python tests/torch_j2k_probe.py [--repo PATH] corpus [--seeds 1-3] [--draws 90] [--copies 8]
    python tests/torch_j2k_probe.py [--repo PATH] time [--reps 10] a.j2k b.png

``--repo`` points at another checkout of the port (a parent commit, for
before-and-after counts). Needs PIL (for its libopenjp2); runs on the CPU.
Prints one JSON line.
"""

import argparse
import collections
import ctypes
import glob
import json
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
COLOR_SPACES = {-1: "unknown", 0: "unspecified", 1: "sRGB", 2: "gray", 3: "sYCC", 4: "e-YCC",
                5: "CMYK"}


class _Comp(ctypes.Structure):
    _fields_ = [("dx", ctypes.c_uint32), ("dy", ctypes.c_uint32), ("w", ctypes.c_uint32),
                ("h", ctypes.c_uint32), ("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("prec", ctypes.c_uint32), ("bpp", ctypes.c_uint32), ("sgnd", ctypes.c_uint32),
                ("resno_decoded", ctypes.c_uint32), ("factor", ctypes.c_uint32),
                ("data", ctypes.c_void_p), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("x1", ctypes.c_uint32),
                ("y1", ctypes.c_uint32), ("numcomps", ctypes.c_uint32),
                ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_Comp)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


def libopenjp2():
    """Pillow's bundled libopenjp2 (its other libraries loaded first)."""
    import PIL
    import PIL._imaging  # noqa: F401 - loads the libraries libopenjp2 sits beside

    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                   "libopenjp2-*.so*"))
    if not found:
        raise SystemExit("no libopenjp2 beside PIL")
    lib = ctypes.CDLL(found[0])
    lib.opj_version.restype = ctypes.c_char_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.opj_create_decompress.restype = ctypes.c_void_p
    lib.opj_create_decompress.argtypes = [ctypes.c_int]
    for name in ("opj_set_error_handler", "opj_set_warning_handler", "opj_set_info_handler"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, _MSG, ctypes.c_void_p]
    lib.opj_set_default_decoder_parameters.argtypes = [ctypes.c_void_p]
    lib.opj_setup_decoder.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_read_header.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.POINTER(_Image))]
    lib.opj_read_tile_header.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint32)] * 2 + [ctypes.POINTER(ctypes.c_int32)] * 4 + \
        [ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int)]
    lib.opj_decode_tile_data.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                         ctypes.c_uint32, ctypes.c_void_p]
    lib.opj_end_decompress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for name in ("opj_stream_destroy", "opj_destroy_codec"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
    return lib


def openjpeg(lib, path: str) -> dict:
    """OpenJPEG's decode of one file as Pillow drives it: its outcome
    ("ok", or the step that failed), the image, the tiles and messages."""
    with open(path, "rb") as f:
        head = f.read(12)
    codec_kind = 0 if head.startswith(b"\xff\x4f\xff\x51") else 2
    messages = []

    def keep(level):
        return _MSG(lambda msg, _: messages.append(f"{level}: {msg.decode(errors='replace').strip()}"))

    handlers = [keep("error"), keep("warning"), keep("info")]
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 1)
    codec = lib.opj_create_decompress(codec_kind)
    lib.opj_set_error_handler(codec, handlers[0], None)
    lib.opj_set_warning_handler(codec, handlers[1], None)
    lib.opj_set_info_handler(codec, handlers[2], None)
    params = ctypes.create_string_buffer(1 << 15)
    lib.opj_set_default_decoder_parameters(params)
    lib.opj_setup_decoder(codec, params)
    image = ctypes.POINTER(_Image)()
    out = {"codec": "jp2" if codec_kind == 2 else "j2k", "outcome": "ok", "tiles": 0}
    try:
        if not lib.opj_read_header(stream, codec, ctypes.byref(image)):
            out["outcome"] = "opj_read_header"
            return out
        im = image.contents
        out["image"] = {"x0": im.x0, "y0": im.y0, "x1": im.x1, "y1": im.y1,
                        "color_space": COLOR_SPACES.get(im.color_space, im.color_space),
                        "comps": [{k: getattr(im.comps[i], k) for k in ("dx", "dy", "prec", "sgnd")}
                                  for i in range(im.numcomps)]}
        while True:
            idx, size, nc, go = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_int()
            x0, y0, x1, y1 = (ctypes.c_int32() for _ in range(4))
            if not lib.opj_read_tile_header(codec, stream, ctypes.byref(idx), ctypes.byref(size),
                                            ctypes.byref(x0), ctypes.byref(y0), ctypes.byref(x1),
                                            ctypes.byref(y1), ctypes.byref(nc), ctypes.byref(go)):
                out["outcome"] = "opj_read_tile_header"
                return out
            if not go.value:
                break
            buf = ctypes.create_string_buffer(max(size.value, 1))
            if not lib.opj_decode_tile_data(codec, idx.value, buf, size.value, stream):
                out["outcome"] = f"opj_decode_tile_data (tile {idx.value})"
                return out
            out["tiles"] += 1
        if not lib.opj_end_decompress(codec, stream):
            out["outcome"] = "opj_end_decompress"
        return out
    finally:
        out["messages"] = [m for m in messages if not m.startswith("info")]
        if image:
            lib.opj_image_destroy(image)
        lib.opj_destroy_codec(codec)
        lib.opj_stream_destroy(stream)


class _CmptParm(ctypes.Structure):
    _fields_ = [(k, ctypes.c_uint32) for k in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                                "sgnd")]


# opj_cparameters_t's fields by byte offset (OpenJPEG 2.5.4 in Pillow's
# build, x86-64): numresolution, the code-block size and roi_compno are
# checked against opj_set_default_encoder_parameters' defaults in
# ``openjpeg_encode``; tp_on, tp_flag and tcp_mct were found by writing
# each byte past cod_format in turn and reading the codestream written
# (cp_cinema at 18684 splits tiles into parts by component)
_CP = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16,
       "cp_disto_alloc": 20, "csty": 48, "prog_order": 52, "POC": 56, "numpocs": 4792,
       "tcp_numlayers": 4796, "tcp_rates": 4800, "numresolution": 5600, "cblockw_init": 5604,
       "cblockh_init": 5608, "mode": 5612, "irreversible": 5616, "roi_compno": 5620,
       "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632, "prch_init": 5764,
       "image_offset_x0": 18188, "image_offset_y0": 18192, "tp_on": 18696, "tp_flag": 18697,
       "tcp_mct": 18698}
_POC_SIZE = 148  # opj_poc_t


def openjpeg_encode(lib, planes, path, size=None, prec=8, sgnd=False, dx=None, dy=None,
                    offset=(0, 0),
                    tile=None, tile_offset=(0, 0), resolutions=6, cblk=(64, 64), precincts=None,
                    prog=0, layers=(0.0,), mode=0, mct=0, sop_eph=0, roi=None, tile_parts=None,
                    pocs=()):
    """A codestream written by OpenJPEG's own encoder (what PIL's encoder
    cannot set: the code-block style bits ``mode`` — 1 BYPASS, 2 RESET, 4
    TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM —, SOP / EPH markers, POCs, RGN,
    tile-parts, subsampled components, any precision) of ``planes``
    (components' int arrays at their own size: ``size`` (W, H) on the
    reference grid from ``offset``, each component ceil((offset + size) /
    d) - ceil(offset / d) samples across) to ``path``; False where
    OpenJPEG refuses the parameters."""
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_create_compress.argtypes = [ctypes.c_int]
    lib.opj_set_default_encoder_parameters.argtypes = [ctypes.c_void_p]
    lib.opj_image_create.restype = ctypes.POINTER(_Image)
    lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.POINTER(_CmptParm), ctypes.c_int]
    lib.opj_setup_encoder.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Image)]
    lib.opj_start_compress.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Image), ctypes.c_void_p]
    lib.opj_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_end_compress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    params = ctypes.create_string_buffer(1 << 15)
    lib.opj_set_default_encoder_parameters(params)
    raw = params.raw
    for k, want in (("numresolution", 6), ("cblockw_init", 64), ("cblockh_init", 64),
                    ("roi_compno", -1)):
        assert int.from_bytes(raw[_CP[k]:_CP[k] + 4], "little", signed=True) == want, k

    def put(name, value, at=0, fmt="i"):
        ctypes.memmove(ctypes.addressof(params) + _CP[name] + at, struct.pack("<" + fmt, value),
                       struct.calcsize(fmt))

    nc = len(planes)
    dx = dx or [1] * nc
    dy = dy or [1] * nc
    W, H = size or (planes[0].shape[1], planes[0].shape[0])
    put("numresolution", resolutions)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("prog_order", prog)
    put("csty", sop_eph)
    put("tcp_numlayers", len(layers))
    for i, r in enumerate(layers):
        put("tcp_rates", r, 4 * i, "f")
    put("cp_disto_alloc", 1)
    put("tcp_mct", mct, 0, "b")
    put("image_offset_x0", offset[0])
    put("image_offset_y0", offset[1])
    if tile:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
        put("cp_tx0", tile_offset[0])
        put("cp_ty0", tile_offset[1])
    if precincts:
        put("csty", sop_eph | 1)
        put("res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):  # exponents; OpenJPEG takes widths
            put("prcw_init", 1 << pw, 4 * i)
            put("prch_init", 1 << ph, 4 * i)
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if tile_parts:
        put("tp_on", 1, 0, "b")
        put("tp_flag", ord(tile_parts), 0, "b")
    put("numpocs", len(pocs))
    for i, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        for j, v in enumerate((r0, c0, l1, r1, c1)):
            put("POC", v, i * _POC_SIZE + 4 * (0, 1, 2, 3, 4)[j])
        put("POC", prg, i * _POC_SIZE + 32)  # prg1
        put("POC", 1, i * _POC_SIZE + 48)  # tile (1-based)
    cparms = (_CmptParm * nc)()
    for i, p in enumerate(planes):
        x0, y0 = -(-offset[0] // dx[i]), -(-offset[1] // dy[i])
        w, h = -(-(offset[0] + W) // dx[i]) - x0, -(-(offset[1] + H) // dy[i]) - y0
        assert p.shape == (h, w), (i, p.shape, (h, w))
        cparms[i] = _CmptParm(dx[i], dy[i], w, h, x0, y0, prec, prec, int(sgnd))
    image = lib.opj_image_create(nc, cparms, 1 if nc >= 3 else 2)
    if not image:  # a component of no samples
        openjpeg_encode.messages = ["opj_image_create failed"]
        return False
    im = image.contents
    im.x0, im.y0, im.x1, im.y1 = offset[0], offset[1], offset[0] + W, offset[1] + H
    for i, p in enumerate(planes):
        c = im.comps[i]
        a = np.ascontiguousarray(p, np.int32)
        assert a.size == c.w * c.h, (a.shape, c.w, c.h)
        ctypes.memmove(c.data, a.ctypes.data, a.nbytes)
    codec = lib.opj_create_compress(0)
    messages = []
    handler = _MSG(lambda msg, _: messages.append(msg.decode(errors="replace").strip()))
    lib.opj_set_error_handler(codec, handler, None)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
    ok = False
    try:
        ok = bool(lib.opj_setup_encoder(codec, params, image)
                  and lib.opj_start_compress(codec, image, stream)
                  and lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream))
    finally:
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
    openjpeg_encode.messages = messages
    return ok


def _pil(path):
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(path) as im:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(HERE))
    ap.add_argument("probe", choices=["file", "corpus", "time"])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--seeds", default="1-3")
    ap.add_argument("--draws", type=int, default=90)
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, args.repo)
    import warnings

    warnings.simplefilter("ignore")
    from rspl_slam_tpu_torch import native

    lib = libopenjp2()
    report = {"openjpeg": lib.opj_version().decode()}
    if args.probe == "time":
        import time

        for p in args.paths:
            with open(p, "rb") as f:
                H, W = native.image_size(f.read())
            native.decode_gray(p, H, W)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                native.decode_gray(p, H, W)
            report[p] = {"ms": (time.perf_counter() - t0) / args.reps * 1e3, "size": [W, H]}
    elif args.probe == "file":
        for p in args.paths:
            with open(p, "rb") as f:
                data = f.read()
            report[p] = {**openjpeg(lib, p), "pil": _pil(p)[0], "port": _port(native, data)[0]}
    else:
        import test_torch_jpeg2000 as T

        a, _, b = args.seeds.partition("-")
        seeds = range(int(a), int(b or a) + 1)
        faults, by_message, total = [], collections.Counter(), 0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "f")
            for seed in seeds:
                rng = np.random.default_rng(seed + 1000)
                for i, data in enumerate(T.corpus(seed, args.draws)):
                    for j, d in enumerate([data] + T.damaged(rng, data, args.copies)):
                        total += 1
                        with open(path, "wb") as f:
                            f.write(d)
                        pil, port = _pil(path), _port(native, d)
                        same = pil[0] == port[0] and (pil[0] != "ok" or np.array_equal(pil[1], port[1]))
                        if same or port[0] == "refused":
                            continue
                        o = openjpeg(lib, path)
                        first = next((m for m in o["messages"] if m.startswith("error")), o["outcome"])
                        by_message[first] += 1
                        faults.append({"seed": seed, "file": i, "copy": j - 1, "pil": pil[0],
                                       "port": port[0], "openjpeg": o["outcome"], "first": first})
        report.update(files=total, disagreements=len(faults),
                      by_first_error=dict(by_message.most_common()), cases=faults[:20])
    print(json.dumps(report, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
