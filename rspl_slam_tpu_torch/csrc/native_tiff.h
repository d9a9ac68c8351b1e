// TIFF as PIL 12's TiffImagePlugin reads frame 0 (the first IFD), then
// convert("L"). Classic TIFF and BigTIFF, both byte orders. The mode comes
// from PIL's OPEN_INFO table (byte order, photometric, sample format, fill
// order, bits per sample, extra samples), copied below; a key missing from
// it is PIL's "unknown pixel mode".
//
// A tag written twice has two values: PIL's IFD keeps its last entry, and
// that view decides the mode, raw mode, size, palette, orientation and the
// route; libtiff keeps the first (TIFFReadDirectory ignores the later
// ones), and that view decides all it decodes: codec, predictor, bits,
// samples, planes, fill order, rows per strip, tiles, offsets, byte counts,
// JPEG tables, subsampling, T4/T6 options, photometric. Pillow's
// TiffDecode.c fails where the two meet badly: libtiff's image size other
// than PIL's, a scanline other than the raw mode's row.
//
// Two routes, as PIL takes them:
//   - uncompressed (1): PIL's own raw decoder over its tile list (strips or
//     tiles, one layer per plane with PlanarConfiguration 2, each plane's
//     rawmode the one character rawmode[layer]), reading from each offset on
//     whatever the byte counts say, fill order 2 by the "R" rawmodes, the
//     predictor ignored;
//   - any other compression: what libtiff hands Pillow's TiffDecode.c
//     (YCbCr: TiffDecode.c's _decodeAsRGBA, below): the stored bytes
//     bit-reversed under fill order 2, decompressed (none, PackBits, LZW,
//     Deflate, LZMA, ZSTD, ThunderScan, JPEG, CCITT), 16/32/64-bit samples
//     of a big-endian file swapped to the (little-endian) host's order, the
//     predictor undone (2 horizontal, 3 floating point: LZW, Deflate, LZMA
//     and ZSTD, as libtiff's codecs set it up), then unpacked with
//     the rawmode of the fill-order-1 key, "I;16" and ";16B"/";16L" read as
//     native (the other big-endian rawmodes, I;16BS, I;32BS and F;32BF, keep
//     their byte order and so read libtiff's swapped samples swapped again,
//     as PIL does). Separate planes of more than one sample (8 or 16 bits)
//     go plane by plane into the mode's bands, the high byte of 16-bit
//     samples, as many planes as the mode has bands (strips fail unless the
//     rawmode holds exactly those bands), and an RGBA image whose first
//     extra sample libtiff calls unspecified or associated alpha is then
//     unpremultiplied; a palette image with an extra plane is refused (PIL
//     reads it past the end of its tile buffer).
//
// Then, as PIL's load_end, ImageOps.exif_transpose: the image decoded at
// its stored size is flipped or rotated by the Orientation tag (274) where
// PIL reads it as a number, or by an XMP packet's tiff:Orientation where the
// tag is absent.
//
// libtiff's own codecs, as it hands their output to Pillow: LZMA
// (native_xz.h), ZSTD (native_zstd.h), ThunderScan (below), new-style JPEG
// (native_tiff_jpeg.h), CCITT (native_fax3.h), and compressed YCbCr and
// old-style JPEG through TIFFRGBAImage (native_tiff_ycbcr.h).
//
// Refused with a code that names the kind: WebP (Pillow's libtiff is built
// without it) and SGILog on other photometrics than LogL / LogLuv (libtiff
// refuses them; LogL and LogLuv are PIL's unknown pixel mode), the JPEG
// layouts named in those headers, CIELAB (PIL's convert("L") raises),
// unknown pixel modes and unknown raw modes (PIL raises on both), and
// layouts PIL reads past the end of its tile buffer.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h, native_png.h and the JPEG decoder: it uses zlib_inflate,
// crc32, JpegDecoder and the Err codes.

struct OpenInfo {
  char order;  // 'I' or 'M'
  int photo, sample_format, fill, nbps;
  int bps[6];
  int nextra;
  int extra[3];
  const char* mode;
  const char* raw;
};

// PIL 12.1's TiffImagePlugin.OPEN_INFO
const OpenInfo kOpenInfo[] = {
    {'I', 0, 1, 1, 1, {1}, 0, {}, "1", "1;I"},
    {'M', 0, 1, 1, 1, {1}, 0, {}, "1", "1;I"},
    {'I', 0, 1, 2, 1, {1}, 0, {}, "1", "1;IR"},
    {'M', 0, 1, 2, 1, {1}, 0, {}, "1", "1;IR"},
    {'I', 1, 1, 1, 1, {1}, 0, {}, "1", "1"},
    {'M', 1, 1, 1, 1, {1}, 0, {}, "1", "1"},
    {'I', 1, 1, 2, 1, {1}, 0, {}, "1", "1;R"},
    {'M', 1, 1, 2, 1, {1}, 0, {}, "1", "1;R"},
    {'I', 0, 1, 1, 1, {2}, 0, {}, "L", "L;2I"},
    {'M', 0, 1, 1, 1, {2}, 0, {}, "L", "L;2I"},
    {'I', 0, 1, 2, 1, {2}, 0, {}, "L", "L;2IR"},
    {'M', 0, 1, 2, 1, {2}, 0, {}, "L", "L;2IR"},
    {'I', 1, 1, 1, 1, {2}, 0, {}, "L", "L;2"},
    {'M', 1, 1, 1, 1, {2}, 0, {}, "L", "L;2"},
    {'I', 1, 1, 2, 1, {2}, 0, {}, "L", "L;2R"},
    {'M', 1, 1, 2, 1, {2}, 0, {}, "L", "L;2R"},
    {'I', 0, 1, 1, 1, {4}, 0, {}, "L", "L;4I"},
    {'M', 0, 1, 1, 1, {4}, 0, {}, "L", "L;4I"},
    {'I', 0, 1, 2, 1, {4}, 0, {}, "L", "L;4IR"},
    {'M', 0, 1, 2, 1, {4}, 0, {}, "L", "L;4IR"},
    {'I', 1, 1, 1, 1, {4}, 0, {}, "L", "L;4"},
    {'M', 1, 1, 1, 1, {4}, 0, {}, "L", "L;4"},
    {'I', 1, 1, 2, 1, {4}, 0, {}, "L", "L;4R"},
    {'M', 1, 1, 2, 1, {4}, 0, {}, "L", "L;4R"},
    {'I', 0, 1, 1, 1, {8}, 0, {}, "L", "L;I"},
    {'M', 0, 1, 1, 1, {8}, 0, {}, "L", "L;I"},
    {'I', 0, 1, 2, 1, {8}, 0, {}, "L", "L;IR"},
    {'M', 0, 1, 2, 1, {8}, 0, {}, "L", "L;IR"},
    {'I', 1, 1, 1, 1, {8}, 0, {}, "L", "L"},
    {'M', 1, 1, 1, 1, {8}, 0, {}, "L", "L"},
    {'I', 1, 2, 1, 1, {8}, 0, {}, "L", "L"},
    {'M', 1, 2, 1, 1, {8}, 0, {}, "L", "L"},
    {'I', 1, 1, 2, 1, {8}, 0, {}, "L", "L;R"},
    {'M', 1, 1, 2, 1, {8}, 0, {}, "L", "L;R"},
    {'I', 1, 1, 1, 1, {12}, 0, {}, "I;16", "I;12"},
    {'I', 0, 1, 1, 1, {16}, 0, {}, "I;16", "I;16"},
    {'I', 1, 1, 1, 1, {16}, 0, {}, "I;16", "I;16"},
    {'M', 1, 1, 1, 1, {16}, 0, {}, "I;16B", "I;16B"},
    {'I', 1, 1, 2, 1, {16}, 0, {}, "I;16", "I;16R"},
    {'I', 1, 2, 1, 1, {16}, 0, {}, "I", "I;16S"},
    {'M', 1, 2, 1, 1, {16}, 0, {}, "I", "I;16BS"},
    {'I', 0, 3, 1, 1, {32}, 0, {}, "F", "F;32F"},
    {'M', 0, 3, 1, 1, {32}, 0, {}, "F", "F;32BF"},
    {'I', 1, 1, 1, 1, {32}, 0, {}, "I", "I;32N"},
    {'I', 1, 2, 1, 1, {32}, 0, {}, "I", "I;32S"},
    {'M', 1, 2, 1, 1, {32}, 0, {}, "I", "I;32BS"},
    {'I', 1, 3, 1, 1, {32}, 0, {}, "F", "F;32F"},
    {'M', 1, 3, 1, 1, {32}, 0, {}, "F", "F;32BF"},
    {'I', 1, 1, 1, 2, {8, 8}, 1, {2}, "LA", "LA"},
    {'M', 1, 1, 1, 2, {8, 8}, 1, {2}, "LA", "LA"},
    {'I', 2, 1, 1, 3, {8, 8, 8}, 0, {}, "RGB", "RGB"},
    {'M', 2, 1, 1, 3, {8, 8, 8}, 0, {}, "RGB", "RGB"},
    {'I', 2, 1, 2, 3, {8, 8, 8}, 0, {}, "RGB", "RGB;R"},
    {'M', 2, 1, 2, 3, {8, 8, 8}, 0, {}, "RGB", "RGB;R"},
    {'I', 2, 1, 1, 4, {8, 8, 8, 8}, 0, {}, "RGBA", "RGBA"},
    {'M', 2, 1, 1, 4, {8, 8, 8, 8}, 0, {}, "RGBA", "RGBA"},
    {'I', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {0}, "RGB", "RGBX"},
    {'M', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {0}, "RGB", "RGBX"},
    {'I', 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {0, 0}, "RGB", "RGBXX"},
    {'M', 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {0, 0}, "RGB", "RGBXX"},
    {'I', 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {0, 0, 0}, "RGB", "RGBXXX"},
    {'M', 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {0, 0, 0}, "RGB", "RGBXXX"},
    {'I', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {1}, "RGBA", "RGBa"},
    {'M', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {1}, "RGBA", "RGBa"},
    {'I', 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {1, 0}, "RGBA", "RGBaX"},
    {'M', 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {1, 0}, "RGBA", "RGBaX"},
    {'I', 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {1, 0, 0}, "RGBA", "RGBaXX"},
    {'M', 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {1, 0, 0}, "RGBA", "RGBaXX"},
    {'I', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {2}, "RGBA", "RGBA"},
    {'M', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {2}, "RGBA", "RGBA"},
    {'I', 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {2, 0}, "RGBA", "RGBAX"},
    {'M', 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {2, 0}, "RGBA", "RGBAX"},
    {'I', 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {2, 0, 0}, "RGBA", "RGBAXX"},
    {'M', 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {2, 0, 0}, "RGBA", "RGBAXX"},
    {'I', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {999}, "RGBA", "RGBA"},
    {'M', 2, 1, 1, 4, {8, 8, 8, 8}, 1, {999}, "RGBA", "RGBA"},
    {'I', 2, 1, 1, 3, {16, 16, 16}, 0, {}, "RGB", "RGB;16L"},
    {'M', 2, 1, 1, 3, {16, 16, 16}, 0, {}, "RGB", "RGB;16B"},
    {'I', 2, 1, 1, 4, {16, 16, 16, 16}, 0, {}, "RGBA", "RGBA;16L"},
    {'M', 2, 1, 1, 4, {16, 16, 16, 16}, 0, {}, "RGBA", "RGBA;16B"},
    {'I', 2, 1, 1, 4, {16, 16, 16, 16}, 1, {0}, "RGB", "RGBX;16L"},
    {'M', 2, 1, 1, 4, {16, 16, 16, 16}, 1, {0}, "RGB", "RGBX;16B"},
    {'I', 2, 1, 1, 4, {16, 16, 16, 16}, 1, {1}, "RGBA", "RGBa;16L"},
    {'M', 2, 1, 1, 4, {16, 16, 16, 16}, 1, {1}, "RGBA", "RGBa;16B"},
    {'I', 2, 1, 1, 4, {16, 16, 16, 16}, 1, {2}, "RGBA", "RGBA;16L"},
    {'M', 2, 1, 1, 4, {16, 16, 16, 16}, 1, {2}, "RGBA", "RGBA;16B"},
    {'I', 3, 1, 1, 1, {1}, 0, {}, "P", "P;1"},
    {'M', 3, 1, 1, 1, {1}, 0, {}, "P", "P;1"},
    {'I', 3, 1, 2, 1, {1}, 0, {}, "P", "P;1R"},
    {'M', 3, 1, 2, 1, {1}, 0, {}, "P", "P;1R"},
    {'I', 3, 1, 1, 1, {2}, 0, {}, "P", "P;2"},
    {'M', 3, 1, 1, 1, {2}, 0, {}, "P", "P;2"},
    {'I', 3, 1, 2, 1, {2}, 0, {}, "P", "P;2R"},
    {'M', 3, 1, 2, 1, {2}, 0, {}, "P", "P;2R"},
    {'I', 3, 1, 1, 1, {4}, 0, {}, "P", "P;4"},
    {'M', 3, 1, 1, 1, {4}, 0, {}, "P", "P;4"},
    {'I', 3, 1, 2, 1, {4}, 0, {}, "P", "P;4R"},
    {'M', 3, 1, 2, 1, {4}, 0, {}, "P", "P;4R"},
    {'I', 3, 1, 1, 1, {8}, 0, {}, "P", "P"},
    {'M', 3, 1, 1, 1, {8}, 0, {}, "P", "P"},
    {'I', 3, 1, 1, 2, {8, 8}, 1, {0}, "P", "PX"},
    {'M', 3, 1, 1, 2, {8, 8}, 1, {0}, "P", "PX"},
    {'I', 3, 1, 1, 2, {8, 8}, 1, {2}, "PA", "PA"},
    {'M', 3, 1, 1, 2, {8, 8}, 1, {2}, "PA", "PA"},
    {'I', 3, 1, 2, 1, {8}, 0, {}, "P", "P;R"},
    {'M', 3, 1, 2, 1, {8}, 0, {}, "P", "P;R"},
    {'I', 5, 1, 1, 4, {8, 8, 8, 8}, 0, {}, "CMYK", "CMYK"},
    {'M', 5, 1, 1, 4, {8, 8, 8, 8}, 0, {}, "CMYK", "CMYK"},
    {'I', 5, 1, 1, 5, {8, 8, 8, 8, 8}, 1, {0}, "CMYK", "CMYKX"},
    {'M', 5, 1, 1, 5, {8, 8, 8, 8, 8}, 1, {0}, "CMYK", "CMYKX"},
    {'I', 5, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 2, {0, 0}, "CMYK", "CMYKXX"},
    {'M', 5, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 2, {0, 0}, "CMYK", "CMYKXX"},
    {'I', 5, 1, 1, 4, {16, 16, 16, 16}, 0, {}, "CMYK", "CMYK;16L"},
    {'M', 5, 1, 1, 4, {16, 16, 16, 16}, 0, {}, "CMYK", "CMYK;16B"},
    {'I', 6, 1, 1, 1, {8}, 0, {}, "L", "L"},
    {'M', 6, 1, 1, 1, {8}, 0, {}, "L", "L"},
    {'I', 6, 1, 1, 3, {8, 8, 8}, 0, {}, "RGB", "RGBX"},
    {'M', 6, 1, 1, 3, {8, 8, 8}, 0, {}, "RGB", "RGBX"},
    {'I', 8, 1, 1, 3, {8, 8, 8}, 0, {}, "LAB", "LAB"},
    {'M', 8, 1, 1, 3, {8, 8, 8}, 0, {}, "LAB", "LAB"},
};

const OpenInfo* open_info(char order, int photo, const std::vector<uint64_t>& sf, int fill,
                          const std::vector<uint64_t>& bps, const std::vector<uint64_t>& extra) {
  if (sf.size() != 1) return nullptr;
  for (const auto& e : kOpenInfo) {
    if (e.order != order || e.photo != photo || e.sample_format != (int)sf[0] ||
        e.fill != fill || e.nbps != (int)bps.size() || e.nextra != (int)extra.size())
      continue;
    bool same = true;
    for (int i = 0; i < e.nbps; ++i) same = same && (uint64_t)e.bps[i] == bps[i];
    for (int i = 0; i < e.nextra; ++i) same = same && (uint64_t)e.extra[i] == extra[i];
    if (same) return &e;
  }
  return nullptr;
}

// ------------------------------------------------------------- the IFD
enum TiffTag {
  kTagWidth = 256, kTagHeight = 257, kTagBps = 258, kTagCompression = 259,
  kTagPhoto = 262, kTagFill = 266, kTagStripOffsets = 273, kTagOrientation = 274,
  kTagSpp = 277, kTagRowsPerStrip = 278, kTagStripBytes = 279, kTagPlanar = 284,
  kTagPredictor = 317, kTagColorMap = 320, kTagTileWidth = 322, kTagTileLength = 323,
  kTagTileOffsets = 324, kTagTileBytes = 325, kTagExtra = 338, kTagSampleFormat = 339,
  kTagXmp = 700, kTagT4Options = 292, kTagT6Options = 293, kTagJpegTables = 347,
  kTagJif = 513, kTagJifLength = 514, kTagJpegRestart = 515, kTagJpegQTables = 519,
  kTagJpegDcTables = 520, kTagJpegAcTables = 521, kTagYccCoefficients = 529,
  kTagYccSubsampling = 530, kTagRefBlackWhite = 532
};

// one IFD entry as stored: its type, count and where its value lies in the file
struct TiffEntry {
  int type = 0;
  uint64_t count = 0, off = 0;
  uint64_t index = 0;  // its place in the IFD
  bool past = false;   // its data lies past the file's end
};

struct TiffIfd {
  bool le = true, big = false;
  // PIL's view, which decides the mode, size, palette, orientation and the
  // route: integer tags' values, the last entry of a tag winning
  std::map<int, std::vector<uint64_t>> tags;
  // libtiff's view, which decides what it decodes: the first entry of each
  // tag (TIFFReadDirectory ignores later ones), where PIL could read it
  std::map<int, std::vector<uint64_t>> first;
  std::map<int, TiffEntry> first_entries;
  bool libtiff_fails = false;  // TIFFFetchDirectory cannot read the IFD whole
  // for EstimateStripByteCounts: the entries, the bytes of their data held
  // outside the IFD, an entry of a type libtiff has no width for
  uint64_t ifd_entries = 0, outside_bytes = 0;
  bool unknown_width = false;
  // ImageOps.exif_transpose's orientation (PIL's load_end applies it): tag
  // 274's value where PIL reads it as a number 2-8, else 0; -1 where it is
  // absent, and then the first tiff:Orientation digit of an XMP packet
  // (tag 700) PIL reads as bytes, or -1; xmp_text: a non-empty XMP packet
  // PIL reads as other than bytes (its bytes pattern then raises)
  int orientation = -1, xmp_orientation = -1;
  bool xmp_text = false;
  std::map<int, TiffEntry> entries;  // every entry PIL keeps, by tag (last wins)
  // what PIL's value of a tag is in Python: 0 an int, 1 a whole number of
  // another type (an IFDRational or float, which compares and hashes as
  // that int), 2 anything else (bytes for BYTE and UNDEFINED, str for ASCII)
  std::map<int, int> pil_kind;
  bool has(int t) const { return tags.count(t) > 0; }
  uint64_t get(int t, uint64_t dflt) const {
    auto it = tags.find(t);
    return it == tags.end() || it->second.empty() ? dflt : it->second[0];
  }
  std::vector<uint64_t> tuple(int t, std::vector<uint64_t> dflt) const {
    auto it = tags.find(t);
    return it == tags.end() ? dflt : it->second;
  }
};

// bytes per value of a TIFF field type PIL knows (0: a type it skips)
inline int tiff_type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: return 8;
    default: return 0;
  }
}

inline uint64_t tiff_uint(const uint8_t* p, int size, bool le) {
  uint64_t v = 0;
  for (int i = 0; i < size; ++i) v |= (uint64_t)p[le ? i : size - 1 - i] << (8 * i);
  return v;
}

// the number PIL reads from a tag's first value where it is a whole one
// (an IFDRational or float equal to an integer compares and hashes as it),
// else 0; BYTE and UNDEFINED values read as bytes, ASCII as a string
int64_t tiff_whole_number(const uint8_t* v, int type, bool le) {
  switch (type) {
    case 3: return (int64_t)tiff_uint(v, 2, le);
    case 4: case 13: return (int64_t)tiff_uint(v, 4, le);
    case 16: return (int64_t)tiff_uint(v, 8, le);
    case 6: return (int8_t)v[0];
    case 8: return (int16_t)tiff_uint(v, 2, le);
    case 9: return (int32_t)tiff_uint(v, 4, le);
    case 5: case 10: {
      const uint64_t a = tiff_uint(v, 4, le), b = tiff_uint(v + 4, 4, le);
      const int64_t num = type == 5 ? (int64_t)a : (int32_t)a;
      const int64_t den = type == 5 ? (int64_t)b : (int32_t)b;
      return den != 0 && num % den == 0 ? num / den : 0;
    }
    case 11: case 12: {
      double x;
      if (type == 11) {
        const uint32_t u = (uint32_t)tiff_uint(v, 4, le);
        float f;
        std::memcpy(&f, &u, 4);
        x = f;
      } else {
        const uint64_t u = tiff_uint(v, 8, le);
        std::memcpy(&x, &u, 8);
      }
      return std::isfinite(x) && x == std::floor(x) && std::fabs(x) < 1e9 ? (int64_t)x : 0;
    }
    default: return 0;
  }
}

// whether a RATIONAL, SRATIONAL, FLOAT or DOUBLE's first value is zero
bool tiff_is_zero(const uint8_t* v, int type, bool le) {
  if (type == 5 || type == 10) return tiff_uint(v, 4, le) == 0 && tiff_uint(v + 4, 4, le) != 0;
  if (type == 11) return (tiff_uint(v, 4, le) & 0x7FFFFFFFu) == 0;
  return (tiff_uint(v, 8, le) & 0x7FFFFFFFFFFFFFFFull) == 0;
}

// the digit of PIL's first match of rb'tiff:Orientation(="|>)([0-9])', or -1
int xmp_orientation_digit(const uint8_t* p, size_t n) {
  static const char key[] = "tiff:Orientation";
  const size_t k = sizeof(key) - 1;
  for (size_t i = 0; i + k + 1 < n; ++i) {
    if (std::memcmp(p + i, key, k)) continue;
    size_t j = i + k;
    if (p[j] == '=' && j + 2 < n && p[j + 1] == '"') j += 2;
    else if (p[j] == '>') j += 1;
    else continue;
    if (j < n && p[j] >= '0' && p[j] <= '9') return p[j] - '0';
  }
  return -1;
}

// PIL's ImageFileDirectory_v2.load of the first IFD: byte order from the
// first two bytes, BigTIFF when the third is 43 (so a big-endian BigTIFF,
// "MM\0\x2b", reads as classic, as in PIL), tags of a type PIL does not
// know (past 16, or 14-15) or whose data lies past the file skipped,
// integer types kept
int tiff_read_ifd(const uint8_t* d, size_t n, TiffIfd& ifd) {
  ifd.le = d[0] == 'I';
  ifd.big = d[2] == 43;
  const size_t head = ifd.big ? 16 : 8;
  if (n < head) return kPassOn;  // the header's offset: struct.error
  uint64_t pos = ifd.big ? tiff_uint(d + 8, 8, ifd.le) : tiff_uint(d + 4, 4, ifd.le);
  if (pos == 0) return kPassOn;  // "no more images in TIFF file" (EOFError)
  if (pos >= (uint64_t)1 << 63) return kCorrupt;  // "Unable to seek to frame" (ValueError)
  const int csize = ifd.big ? 8 : 2, esize = ifd.big ? 20 : 12, inline_max = ifd.big ? 8 : 4;
  // an IFD cut short keeps the entries read before the cut (load's OSError
  // "Corrupt EXIF data" is a warning); none past the file
  if (pos > n || n - pos < (uint64_t)csize) {
    ifd.libtiff_fails = true;  // "Can not read TIFF directory count"
    return kOk;
  }
  uint64_t count = tiff_uint(d + pos, csize, ifd.le);
  pos += csize;
  // TIFFFetchDirectory: "Sanity check on directory count failed", "Can not
  // read TIFF directory"
  ifd.libtiff_fails = count > 4096 || count > (n - pos) / esize;
  count = std::min<uint64_t>(count, (n - pos) / esize);
  std::set<int> seen;
  bool pil_done = false;  // PIL's load ended at an entry whose data lies past the file
  ifd.ifd_entries = count;
  for (uint64_t k = 0; k < count; ++k, pos += esize) {
    const uint8_t* e = d + pos;
    const int tag = (int)tiff_uint(e, 2, ifd.le), type = (int)tiff_uint(e + 2, 2, ifd.le);
    const bool first = seen.insert(tag).second;
    const uint64_t cnt = tiff_uint(e + 4, ifd.big ? 8 : 4, ifd.le);
    {  // TIFFDataWidth
      const int w = tiff_type_size(type) ? tiff_type_size(type) : type == 17 || type == 18 ? 8 : 0;
      if (!w || cnt > UINT64_MAX / 8) ifd.unknown_width = true;
      else if (cnt * w > (uint64_t)inline_max) ifd.outside_bytes += cnt * w;
    }
    const uint8_t* val = e + (ifd.big ? 12 : 8);
    const int unit = tiff_type_size(type);
    if (!unit || cnt == 0 || cnt > (uint64_t)1 << 40) {
      // PIL skips a type it does not know and an empty entry; libtiff
      // cannot read either where it must
      if (first) {
        ifd.first[tag] = {};
        ifd.first_entries[tag] = TiffEntry{type, cnt, 0, k, true};
      }
      continue;
    }
    const uint64_t size = cnt * unit;
    const uint8_t* src = val;
    if (size > (uint64_t)inline_max) {
      const uint64_t off = tiff_uint(val, inline_max, ifd.le);
      if (off > n || n - off < size) {
        // PIL: "Truncated File Read", and its load ends there (the OSError
        // a warning); libtiff fails on the entry where it must read it
        pil_done = true;
        if (first) {
          ifd.first[tag] = {};
          ifd.first_entries[tag] = TiffEntry{type, cnt, off, k, true};
        }
        continue;
      }
      src = d + off;
    }
    const TiffEntry entry{type, cnt, (uint64_t)(src - d), k};
    std::vector<uint64_t> vals;
    int kind = 2;
    if (type == 1 || type == 3 || type == 4 || type == 6 || type == 8 || type == 9 ||
        type == 13 || type == 16) {
      vals.resize(cnt);
      for (uint64_t i = 0; i < cnt; ++i) {
        uint64_t v = tiff_uint(src + i * unit, unit, ifd.le);
        if (type == 6) v = (uint64_t)(int64_t)(int8_t)v;
        if (type == 8) v = (uint64_t)(int64_t)(int16_t)v;
        if (type == 9) v = (uint64_t)(int64_t)(int32_t)v;
        vals[i] = v;
      }
      kind = type == 1 ? 2 : 0;  // BYTE: bytes to PIL, a number to libtiff
    } else if (type == 5 || type == 10 || type == 11 || type == 12) {
      const int64_t v = tiff_whole_number(src, type, ifd.le);
      const bool whole = v != 0 || tiff_is_zero(src, type, ifd.le);
      vals.assign(1, (uint64_t)v);
      kind = whole ? 1 : 2;
    } else {
      vals.assign(1, 0);  // present, not a number
    }
    if (first) {
      ifd.first[tag] = vals;
      ifd.first_entries[tag] = entry;
    }
    if (pil_done) continue;
    ifd.entries[tag] = entry;
    ifd.pil_kind[tag] = kind;
    if (tag == kTagOrientation) {
      const int64_t v = tiff_whole_number(src, type, ifd.le);
      ifd.orientation = v >= 2 && v <= 8 ? (int)v : 0;
    }
    if (tag == kTagXmp) {
      const bool bytes = type == 1 || type == 7;
      ifd.xmp_orientation = bytes ? xmp_orientation_digit(src, size) : -1;
      // a string of one NUL reads as "", a single zero number as 0: falsy
      ifd.xmp_text = !bytes && !(cnt == 1 && std::all_of(src, src + size,
                                                       [](uint8_t b) { return b == 0; }));
    }
    ifd.tags[tag] = std::move(vals);
  }
  return kOk;
}

// the IFD as libtiff sees it: StripOffsets and TileOffsets set one field
// (as do the two byte counts), the later entry of the pair in the IFD
// winning
TiffIfd tiff_libtiff_ifd(const TiffIfd& f) {
  TiffIfd g = f;
  g.tags = f.first;
  g.entries = f.first_entries;
  for (auto [a, b] : {std::pair<int, int>{273, 324}, {279, 325}}) {
    const auto ea = g.entries.find(a), eb = g.entries.find(b);
    if (ea == g.entries.end() || eb == g.entries.end()) continue;
    const int win = ea->second.index > eb->second.index ? a : b;
    g.tags[a] = g.tags[b] = g.tags[win];
    g.entries[a] = g.entries[b] = g.entries[win];
  }
  return g;
}

// libtiff's TIFFIsTiled: a TileWidth or TileLength tag
bool tiff_libtiff_tiled(const TiffIfd& f) { return f.has(322) || f.has(323); }

// libtiff's segment layout: tiles of TileWidth × TileLength, a dimension
// without its tag being what RowsPerStrip set it to (the image's width, the
// rows a strip); else strips of RowsPerStrip rows (at most the image's).
// The offsets and byte counts, padded with zeros to the segments' number
// (TIFFFetchStripThing), or false where libtiff has none.
// TIFFFetchStripThing: the first `k` values of a strile array entry
// (TIFFReadDirEntryLong8ArrayWithLimit reads no more than the striles,
// from where the entry's own count puts them), zeros past a short array;
// false where the values do not lie in the file or are no integers
bool tiff_strile_array(const uint8_t* d, size_t n, const TiffIfd& f, int tag, uint64_t k,
                       std::vector<uint64_t>& out) {
  const auto it = f.entries.find(tag);
  const TiffEntry& e = it->second;
  const int unit = tiff_type_size(e.type);
  if (!(e.type == 1 || e.type == 3 || e.type == 4 || e.type == 6 || e.type == 8 ||
        e.type == 9 || e.type == 13 || e.type == 16))
    return false;
  const uint64_t have = std::min<uint64_t>(e.count, k);
  if (e.off > n || (n - e.off) / unit < have) return false;
  out.assign((size_t)k, 0);
  for (uint64_t i = 0; i < have; ++i) {
    uint64_t v = tiff_uint(d + e.off + i * unit, unit, f.le);
    if (e.type == 6) v = (uint64_t)(int64_t)(int8_t)v;
    if (e.type == 8) v = (uint64_t)(int64_t)(int16_t)v;
    if (e.type == 9) v = (uint64_t)(int64_t)(int32_t)v;
    out[(size_t)i] = v;
  }
  return true;
}

bool tiff_libtiff_layout(const uint8_t* d, size_t n, const TiffIfd& f, int xsize, int ysize,
                         int64_t& sw, int64_t& sh, std::vector<uint64_t>& offs,
                         std::vector<uint64_t>& counts, int64_t planes) {
  if (tiff_libtiff_tiled(f)) {
    sw = (int64_t)f.get(kTagTileWidth, f.has(kTagRowsPerStrip) ? (uint64_t)xsize : 0);
    sh = (int64_t)f.get(kTagTileLength, f.get(kTagRowsPerStrip, 0));
  } else {
    sw = xsize;
    sh = (int64_t)std::min<uint64_t>(f.get(kTagRowsPerStrip, 0xFFFFFFFFu), (uint64_t)ysize);
  }
  if (sw <= 0 || sh <= 0 || sw > (1 << 24)) return false;
  if (!f.has(kTagStripOffsets) && !f.has(kTagTileOffsets)) return false;
  const uint64_t k = (uint64_t)((xsize + sw - 1) / sw * ((ysize + sh - 1) / sh) * planes);
  const int offs_tag = f.has(kTagStripOffsets) ? kTagStripOffsets : kTagTileOffsets;
  if (!tiff_strile_array(d, n, f, offs_tag, k, offs)) return false;
  // EstimateStripByteCounts for a compressed image: the file less its
  // header, IFD and outside data, a plane's share of it, the last cut at
  // the file's end
  auto estimate = [&]() {
    if (f.get(kTagCompression, 1) == 1 || f.unknown_width) return false;
    const uint64_t head = f.big ? 16 + 8 + f.ifd_entries * 20 + 8 : 8 + 2 + f.ifd_entries * 12 + 4;
    const uint64_t used = head + f.outside_bytes;
    uint64_t space = n < used ? n : n - used;
    if (planes > 1) space /= (uint64_t)planes;
    counts.assign((size_t)k, space);
    const uint64_t last = offs.back();
    if (last + counts.back() > n) counts.back() = last >= n ? 0 : n - last;
    return true;
  };
  const bool one_strip = !tiff_libtiff_tiled(f) && k == 1;
  if (!f.has(kTagStripBytes) && !f.has(kTagTileBytes)) {
    // TIFFReadDirectory estimates them for one strip a plane, else
    // "MissingRequired"
    return (int64_t)k == planes && estimate();
  }
  const int counts_tag = f.has(kTagStripBytes) ? kTagStripBytes : kTagTileBytes;
  if (!tiff_strile_array(d, n, f, counts_tag, k, counts)) return one_strip && estimate();
  // "Bogus StripByteCounts field": one strip of 0 bytes at an offset
  if (one_strip && counts[0] == 0 && offs[0] != 0) return estimate();
  return true;
}

// ---------------------------------------------------------- the setup
struct TiffInfo {
  TiffIfd ifd;
  int compression = 1, planar = 1, photo = 0, fill = 1;
  int xsize = 0, ysize = 0;  // the stored size
  int orientation = 1;       // the transpose PIL applies after decoding
  bool xmp_fails = false;    // PIL's exif_transpose raises on the XMP packet
  int w = 0, h = 0;          // the image's: the stored size, swapped for orientations 5-8
  std::vector<uint64_t> bps, extra, sf;
  int spp = 1, bps_count = 1;
  const OpenInfo* key = nullptr;
  PilMode mode = kModeNone;
};

// TiffImageFile._setup up to the mode: kPassOn where it raises an error
// Image.open takes for "not this format" (SyntaxError, TypeError,
// KeyError, EOFError, struct.error: UnidentifiedImageError, unless a later
// plugin opens the file), kCorrupt where it raises another, kTiffMode for
// "unknown pixel mode"
int tiff_setup(const uint8_t* d, size_t n, TiffInfo& t) {
  int rc = tiff_read_ifd(d, n, t.ifd);
  if (rc) return rc;
  const TiffIfd& f = t.ifd;
  if (f.has(0xBC01)) return kCorrupt;  // "Windows Media Photo files not yet supported"
  auto kind = [&](int tag) {
    const auto it = f.pil_kind.find(tag);
    return it == f.pil_kind.end() ? 0 : it->second;
  };
  t.compression = (int)f.get(kTagCompression, 1);
  static const int known[] = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676,
                              34677, 34925, 50000, 50001};
  if (kind(kTagCompression) == 2 ||
      std::find(std::begin(known), std::end(known), t.compression) == std::end(known))
    return kPassOn;  // COMPRESSION_INFO has no name for it: KeyError
  t.planar = kind(kTagPlanar) == 2 ? 1 : (int)f.get(kTagPlanar, 1);  // bytes: not 2
  t.photo = (int)f.get(kTagPhoto, 0);
  if (t.compression == 6) t.photo = 6;  // old-style JPEG: YCbCr
  t.fill = (int)f.get(kTagFill, 1);
  if (!f.has(kTagWidth) || !f.has(kTagHeight)) return kPassOn;  // "Missing dimensions"
  if (kind(kTagWidth) || kind(kTagHeight)) return kCorrupt;  // "Invalid dimensions"
  const uint64_t xs = f.get(kTagWidth, 0), ys = f.get(kTagHeight, 0);
  if ((int64_t)xs <= 0 || (int64_t)ys <= 0)
    return kPassOn;  // ImageFile: "not identified by this driver"
  if (xs > (1 << 24) || ys > (1 << 24) || xs * ys > kMaxPixels)
    return kCorrupt;  // past PIL's decompression-bomb limit too
  t.xsize = (int)xs;
  t.ysize = (int)ys;
  // Image.getexif finds tag 274 in the IFD, else consults the XMP packet
  if (f.orientation >= 0) {
    t.orientation = f.orientation;
  } else {
    t.orientation = f.xmp_orientation;
    t.xmp_fails = f.xmp_text;
  }
  if (t.orientation < 2 || t.orientation > 8) t.orientation = 1;
  const bool swap = t.orientation >= 5;
  t.w = swap ? t.ysize : t.xsize;
  t.h = swap ? t.xsize : t.ysize;
  t.sf = f.tuple(kTagSampleFormat, {1});
  if (t.sf.size() > 1 && *std::max_element(t.sf.begin(), t.sf.end()) == 1 &&
      *std::min_element(t.sf.begin(), t.sf.end()) == 1)
    t.sf = {1};
  t.bps = f.tuple(kTagBps, {1});
  t.extra = f.tuple(kTagExtra, {});
  t.bps_count = (t.photo == 2 || t.photo == 6 || t.photo == 8) ? 3 : t.photo == 5 ? 4 : 1;
  t.bps_count += (int)t.extra.size();
  const bool jpeg_colour = t.compression == 6 && (t.photo == 2 || t.photo == 6);
  const uint64_t spp = f.get(kTagSpp, jpeg_colour ? 3 : 1);
  if (kind(kTagSpp) == 2) return kPassOn;  // bytes > int: TypeError
  if (spp > 6) return kPassOn;  // "Invalid value for samples per pixel" (SyntaxError)
  t.spp = (int)spp;
  if (spp < t.bps.size()) t.bps.resize(spp);
  else if (spp > t.bps.size() && t.bps.size() == 1) t.bps.assign(spp, t.bps[0]);
  if (t.bps.size() != spp) return kPassOn;  // "unknown data organization" (SyntaxError)
  // a value PIL holds as bytes or a str is in no OPEN_INFO key
  for (int tag : {(int)kTagPhoto, (int)kTagFill, (int)kTagSampleFormat, (int)kTagBps,
                  (int)kTagExtra})
    if (kind(tag) == 2 && !(tag == kTagPhoto && t.compression == 6)) return kTiffMode;
  t.key = open_info(t.ifd.le ? 'I' : 'M', t.photo, t.sf, t.fill, t.bps, t.extra);
  if (!t.key) return kTiffMode;
  t.mode = pil_mode(t.key->mode);
  return kOk;
}

// the fields libtiff decodes PIL's libtiff route with, from its own view
// of the IFD (mode, raw mode, size, palette and orientation stay PIL's):
// kCorrupt where libtiff's TIFFReadDirectory fails on them, or where
// Pillow's TiffDecode.c finds libtiff's image size other than its own
int tiff_libtiff_view(const TiffInfo& t, TiffInfo& lt) {
  if (t.ifd.libtiff_fails) return kCorrupt;
  lt = t;
  lt.ifd = tiff_libtiff_ifd(t.ifd);
  TiffIfd& f = lt.ifd;
  // TIFFReadDirectory's reads of the tags that size the image: one value
  // (TIFFReadDirEntryShort / Long) of an integer type within the field's
  // range, or one a sample where it takes that (Persample), then
  // _TIFFVSetField's checks; a failure fails the open where the tag is
  // essential, and drops the tag (its default) where libtiff recovers
  auto value_of = [&](int tag, uint64_t max, bool per_sample, uint64_t spp,
                      uint64_t& v) -> bool {
    const TiffEntry& e = f.entries[tag];
    const int type = e.type;
    const bool is_int = type == 1 || type == 3 || type == 4 || type == 6 || type == 8 ||
                        type == 9 || type == 16;
    if (!is_int || (e.count != 1 && (!per_sample || e.count < spp)) || e.past) return false;
    const std::vector<uint64_t>& vals = f.tags[tag];
    const bool is_signed = type == 6 || type == 8 || type == 9;
    auto fits = [&](uint64_t x) { return !(is_signed && (int64_t)x < 0) && x <= max; };
    if (vals.size() == 1) {
      v = vals[0];
      return fits(v);
    }
    if (!per_sample || vals.size() < spp) return false;
    for (uint64_t i = 0; i < spp; ++i)
      if (!fits(vals[i]) || vals[i] != vals[0]) return false;
    v = vals[0];
    return true;
  };
  uint64_t v = 0, spp_v = 1;
  if (f.has(kTagSpp)) {
    if (!value_of(kTagSpp, 0xFFFF, false, 1, spp_v) || spp_v == 0) return kCorrupt;
  }
  if (f.has(kTagCompression) && !value_of(kTagCompression, 0xFFFF, true, spp_v, v))
    return kCorrupt;
  for (int tag : {(int)kTagWidth, (int)kTagHeight, (int)kTagTileWidth, (int)kTagTileLength,
                  (int)kTagRowsPerStrip})
    if (f.has(tag) && (!value_of(tag, 0xFFFFFFFFu, false, 1, v) ||
                       (tag == kTagRowsPerStrip && v == 0)))
      return kCorrupt;
  if (f.has(kTagPlanar) && (!value_of(kTagPlanar, 0xFFFF, false, 1, v) || (v != 1 && v != 2)))
    return kCorrupt;
  for (int tag : {(int)kTagBps, (int)kTagSampleFormat})
    if (f.has(tag) && (!value_of(tag, 0xFFFF, true, spp_v, v) ||
                       (tag == kTagSampleFormat && (v < 1 || v > 6))))
      return kCorrupt;
  if (f.has(kTagExtra)) {  // setExtraSamples: at most a sample each, 0-2 (999 read as 2)
    const std::vector<uint64_t>& ex = f.tags[kTagExtra];
    const int type = f.entries[kTagExtra].type;
    if (!(type == 1 || type == 3 || type == 4 || type == 16) || ex.size() > spp_v) return kCorrupt;
    for (uint64_t x : ex)
      if (x > 2 && x != 999) return kCorrupt;
  }
  for (int tag : {(int)kTagPhoto, (int)kTagFill, (int)kTagPredictor})
    if (f.has(tag) && (!value_of(tag, 0xFFFF, false, 1, v) ||
                       (tag == kTagFill && v != 1 && v != 2))) {
      f.tags.erase(tag);  // recovered: the default
      f.entries.erase(tag);
    }
  lt.compression = (int)f.get(kTagCompression, 1);
  lt.planar = (int)f.get(kTagPlanar, 1);
  lt.photo = (int)f.get(kTagPhoto, 0);
  if (lt.compression == 6) lt.photo = 6;
  lt.fill = (int)f.get(kTagFill, 1);
  if (f.get(kTagWidth, 0) != (uint64_t)t.xsize || f.get(kTagHeight, 0) != (uint64_t)t.ysize)
    return kCorrupt;
  const bool jpeg_colour = lt.compression == 6 && (lt.photo == 2 || lt.photo == 6);
  lt.spp = f.has(kTagSpp) ? (int)spp_v : jpeg_colour ? 3 : 1;
  lt.bps.assign(lt.spp, f.get(kTagBps, 1));  // one value for every sample
  lt.sf.assign(lt.spp, f.get(kTagSampleFormat, 1));
  lt.extra = f.tuple(kTagExtra, {});
  return kOk;
}

// --------------------------------------------------------- the codecs
// libtiff's PackBits decode: a literal run of n + 1 bytes for n ≥ 0, a
// repeat of 1 − n for n in [−127, −1], −128 skipped; output past the
// expected size discarded
bool packbits_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t expect) {
  out.clear();
  size_t i = 0;
  while (i < n && out.size() < expect) {
    const int c = (int8_t)p[i++];
    if (c >= 0) {
      const size_t k = std::min<size_t>(c + 1, n - i);
      out.insert(out.end(), p + i, p + i + k);
      i += k;
    } else if (c != -128) {
      if (i >= n) break;
      out.insert(out.end(), (size_t)(1 - c), p[i++]);
    }
  }
  if (out.size() < expect) return false;
  out.resize(expect);
  return true;
}

// TIFF LZW: MSB-first codes of 9 to 12 bits, Clear 256 and EOI 257; the
// width grows as the next free code reaches 511, 1023 and 2047 (the
// "early change" libtiff decodes)
bool lzw_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t expect) {
  out.clear();
  out.reserve(expect);
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  uint64_t acc = 0;
  int nacc = 0, width = 9, next = 258, old = -1;
  size_t i = 0;
  std::vector<uint8_t> tmp(4096);
  while (out.size() < expect) {
    while (nacc < width) {
      if (i >= n) return false;  // "Not enough data"
      acc = (acc << 8) | p[i++];
      nacc += 8;
    }
    const int code = (int)((acc >> (nacc - width)) & ((1u << width) - 1));
    nacc -= width;
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    int emit;
    if (old < 0) {
      if (code > 255) return false;
      out.push_back((uint8_t)code);
      old = code;
      continue;
    }
    if (code < next) {
      emit = code;
      if (next < 4096) {
        prefix[next] = (uint16_t)old;
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = (uint16_t)(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = (uint16_t)old;
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      emit = next++;
    } else {
      return false;  // "Corrupted LZW table"
    }
    const int len = length[emit];
    for (int k = len - 1, c = emit; k >= 0; --k, c = prefix[c]) tmp[k] = suffix[c];
    out.insert(out.end(), tmp.begin(), tmp.begin() + len);
    old = emit;
    if (next >= (1 << width) - 1 && width < 12) ++width;
  }
  if (out.size() < expect) return false;
  out.resize(expect);
  return true;
}

// libtiff's horizontal accumulation (predictor 2) of one row of native
// samples: `stride` samples per pixel (rows need not be aligned)
template <typename T>
void hor_acc_t(uint8_t* row, size_t nsamples, int stride) {
  for (size_t i = stride; i < nsamples; ++i) {
    T a, b;
    std::memcpy(&a, row + i * sizeof(T), sizeof(T));
    std::memcpy(&b, row + (i - stride) * sizeof(T), sizeof(T));
    a = (T)(a + b);
    std::memcpy(row + i * sizeof(T), &a, sizeof(T));
  }
}

void hor_acc(uint8_t* row, size_t nsamples, int bits, int stride) {
  if (bits == 8) hor_acc_t<uint8_t>(row, nsamples, stride);
  else if (bits == 16) hor_acc_t<uint16_t>(row, nsamples, stride);
  else if (bits == 32) hor_acc_t<uint32_t>(row, nsamples, stride);
  else hor_acc_t<uint64_t>(row, nsamples, stride);
}

// libtiff's fpAcc (predictor 3): bytes accumulated `stride` apart, then
// the byte planes (most significant first) regrouped into little-endian
// samples
void fp_acc(uint8_t* row, size_t bytes, int bits, int stride, std::vector<uint8_t>& tmp) {
  for (size_t i = stride; i < bytes; ++i) row[i] = (uint8_t)(row[i] + row[i - stride]);
  const int bps = bits / 8;
  const size_t wc = bytes / bps;
  tmp.assign(row, row + bytes);
  for (size_t c = 0; c < wc; ++c)
    for (int b = 0; b < bps; ++b) row[bps * c + b] = tmp[(size_t)(bps - b - 1) * wc + c];
}

// libtiff's ThunderScan decoder (tif_thunder.c's ThunderDecode, one call
// a row of `width` 4-bit pixels packed two to a byte): a 2-bit code and 6
// bits of data a byte: a run of the last pixel, three 2-bit or two 3-bit
// deltas (code 2 and 4 emit nothing), or a raw pixel. A row must end at
// exactly `width` pixels: a run past it is "Too much data", the strip's end
// before it "Not enough data", both fatal.
bool thunder_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t rows,
                    size_t row_bytes, int width) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  out.assign(rows * row_bytes, 0);
  size_t i = 0;
  for (size_t r = 0; r < rows; ++r) {
    uint8_t* op = out.data() + r * row_bytes;
    unsigned last = 0;
    int64_t npixels = 0;
    const int64_t maxpixels = width;
    auto set = [&](unsigned v) {
      last = v & 0xF;
      if (npixels < maxpixels) {
        if (npixels++ & 1) *op++ |= (uint8_t)last;
        else op[0] = (uint8_t)(last << 4);
      }
    };
    while (i < n && npixels < maxpixels) {
      int c = p[i++], delta;
      switch (c & 0xC0) {
        case 0x00: {  // a run of the last pixel, c & 0x3F long
          int k = c & 0x3F;
          if (npixels & 1) {
            op[0] |= (uint8_t)last;
            last = *op++;
            ++npixels;
            --k;
          } else {
            last |= last << 4;
          }
          npixels += k;
          if (npixels <= maxpixels)  // a run may end the row
            for (; k > 0; k -= 2) *op++ = (uint8_t)last;
          if (k == -1) *--op &= 0xF0;
          last &= 0xF;
          break;
        }
        case 0x40:
          if ((delta = (c >> 4) & 3) != 2) set((unsigned)((int)last + two[delta]));
          if ((delta = (c >> 2) & 3) != 2) set((unsigned)((int)last + two[delta]));
          if ((delta = c & 3) != 2) set((unsigned)((int)last + two[delta]));
          break;
        case 0x80:
          if ((delta = (c >> 3) & 7) != 4) set((unsigned)((int)last + three[delta]));
          if ((delta = c & 7) != 4) set((unsigned)((int)last + three[delta]));
          break;
        default:
          set((unsigned)c);
      }
    }
    if (npixels != maxpixels) return false;
  }
  return true;
}

#include "native_fax3.h"
#include "native_tiff_jpeg.h"
#include "native_xz.h"
#include "native_zstd.h"

// what libtiff's codecs know of the segment they decode
struct TiffSeg {
  int w = 0, h = 0;       // its width and height in pixels
  bool last = false;      // a strip that ends the image
  bool separate = false;  // one plane of PlanarConfiguration 2
  bool tile = false;      // a tile (libtiff reads it with TIFFReadEncodedTile)
  bool raw = false;       // the predictor left undone (libtiff's own refusal)
  // TIFFRGBAImage (stoponerr 0) goes on past a codec's failure, with what
  // the codec left in the strip buffer: what it decoded, then zeros
  bool tolerant = false;
  FaxCodec* fax = nullptr;  // libtiff's CCITT codec state, kept across segments
};

// one strip or tile of the libtiff route → rows × row_bytes native bytes
int tiff_segment(const uint8_t* d, size_t n, const TiffInfo& t, uint64_t off, uint64_t count,
                 size_t rows, size_t row_bytes, int samples_per_row_pixel, int bits,
                 std::vector<uint8_t>& out, const TiffSeg& sg) {
  // TIFFFillStrip / TIFFFillTile: "Invalid strip byte count", "Read error"
  if (count == 0 || off > n || n - off < count) return kCorrupt;
  if (t.compression == 7)  // libtiff's JPEG codec reverses no bits
    return tiff_jpeg_segment(d, n, t, d + off, (size_t)count, sg.w, sg.h, sg.last, sg.separate,
                             rows, row_bytes, out);
  std::vector<uint8_t> src(d + off, d + off + count);
  if (t.fill == 2)
    for (auto& b : src) b = bitflip(b);
  const size_t expect = rows * row_bytes;
  if (is_ccitt(t.compression)) {
    const int rc = fax_decode(src.data(), src.size(), t.compression, fax_options(t), sg.w, rows,
                              out, (off & 1) != 0, *sg.fax);
    // TIFFReadEncodedTile takes the decoder's -1 for success (it tests for
    // non-zero), TIFFReadEncodedStrip does not
    return sg.tile ? kOk : rc;
  }
  bool ok;
  if (t.compression == 1) {  // DumpModeDecode: "Not enough data for scanline"
    ok = src.size() >= expect;
    out.assign(src.begin(), src.begin() + (ok ? expect : 0));
  } else if (t.compression == 32773) {
    ok = packbits_decode(src.data(), src.size(), out, expect);
  } else if (t.compression == 5) {
    ok = lzw_decode(src.data(), src.size(), out, expect);
  } else if (t.compression == 34925) {
    ok = xz_decode(src.data(), src.size(), out, expect);
  } else if (t.compression == 50000) {
    ok = zstd_decode(src.data(), src.size(), out, expect);
  } else if (t.compression == 32809) {
    // ThunderSetupDecode takes 4-bit samples only; no tile decoder
    ok = bits == 4 && !sg.tile && thunder_decode(src.data(), src.size(), out, rows, row_bytes, sg.w);
  } else {
    ok = zlib_inflate(src.data(), src.size(), out, expect) == kOk && out.size() >= expect;
    if (ok) out.resize(expect);
  }
  if (!ok && sg.tolerant) {
    out.resize(expect, 0);
    return kOk;  // the predictor only runs after a decode that succeeds
  }
  if (!ok) return kCorrupt;
  const bool predicts = t.compression != 1 && t.compression != 32773 && t.compression != 32809 &&
                        !sg.raw;
  const int predictor = predicts ? (int)t.ifd.get(kTagPredictor, 1) : 1;
  const bool swab = !t.ifd.le && (bits == 16 || bits == 32 || bits == 64) && predictor != 3;
  if (swab) {
    const int bb = bits / 8;
    for (size_t i = 0; i + bb <= out.size(); i += bb) std::reverse(&out[i], &out[i] + bb);
  }
  if (predictor == 1) return kOk;
  std::vector<uint8_t> tmp;
  for (size_t r = 0; r < rows; ++r) {
    uint8_t* row = out.data() + r * row_bytes;
    if (predictor == 2) {
      if (bits != 8 && bits != 16 && bits != 32 && bits != 64) return kCorrupt;
      hor_acc(row, row_bytes / (bits / 8), bits, samples_per_row_pixel);
    } else if (predictor == 3) {
      if (t.sf[0] != 3 || (bits != 16 && bits != 24 && bits != 32 && bits != 64)) return kCorrupt;
      fp_acc(row, row_bytes, bits, samples_per_row_pixel, tmp);
    } else {
      return kCorrupt;  // "Predictor value not supported"
    }
  }
  return kOk;
}

// --------------------------------------------------------- the decode
int tiff_palette(const TiffInfo& t, PilImage& im) {
  auto it = t.ifd.tags.find(kTagColorMap);
  if (it == t.ifd.tags.end()) return kPassOn;  // self.tag_v2[COLORMAP]: KeyError
  const std::vector<uint64_t>& cm = it->second;
  const size_t entries = cm.size() / 3;
  if (entries > 256) return kCorrupt;  // "invalid palette size"
  for (size_t i = 0; i < entries; ++i)
    for (int c = 0; c < 3; ++c) im.pal[3 * i + c] = (uint8_t)((cm[c * entries + i] / 256) & 255);
  im.pal_n = (int)entries;
  return kOk;
}

int decode_tiff_raw(const uint8_t* d, size_t n, const TiffInfo& t, PilImage& im) {
  const TiffIfd& f = t.ifd;
  std::vector<uint64_t> offsets;
  int64_t w, h;
  if (f.has(kTagStripOffsets)) {
    offsets = f.tuple(kTagStripOffsets, {});
    h = (int64_t)f.get(kTagRowsPerStrip, t.ysize);
    w = t.xsize;
  } else if (f.has(kTagTileOffsets)) {
    offsets = f.tuple(kTagTileOffsets, {});
    if (!f.has(kTagTileWidth) || !f.has(kTagTileLength)) return kCorrupt;
    w = (int64_t)f.get(kTagTileWidth, 0);
    h = (int64_t)f.get(kTagTileLength, 0);
  } else {
    return kPassOn;  // "unknown data organization" (SyntaxError)
  }
  if (w <= 0 || h <= 0) return kCorrupt;
  if (w == t.xsize && h == t.ysize && t.planar != 2 && !offsets.empty())
    offsets = {offsets.back()};  // every tile covers the image: the last offset
  double sum_bps = 0;
  for (uint64_t b : t.bps) sum_bps += (double)b;
  struct Tile { uint64_t off; int x0, y0, xs, ys; const UnpackerDef* u; int64_t stride; };
  std::vector<Tile> tiles;
  const std::string raw = t.key->raw;
  int64_t x = 0, y = 0;
  size_t layer = 0;
  for (uint64_t off : offsets) {
    double stride = x + w > t.xsize ? (double)w * sum_bps / 8 : 0.0;
    std::string tile_raw = raw;
    if (t.planar == 2) {
      if (layer >= raw.size()) return kPassOn;  // rawmode[layer]: IndexError
      tile_raw = std::string(1, raw[layer]);
      stride /= t.bps_count;
    }
    const UnpackerDef* u = find_unpacker(t.mode, tile_raw);
    if (!u) return kTiffRawMode;
    const int64_t x1 = std::min<int64_t>(x + w, t.xsize), y1 = std::min<int64_t>(y + h, t.ysize);
    tiles.push_back({off, (int)x, (int)y, (int)(x1 - x), (int)(y1 - y), u, (int64_t)stride});
    x += w;
    if (x >= t.xsize) {
      x = 0;
      y += h;
      if (y >= t.ysize) {
        y = 0;
        ++layer;
      }
    }
  }
  // ImageFile.load decodes the tiles in the order of their offsets
  std::stable_sort(tiles.begin(), tiles.end(),
                   [](const Tile& a, const Tile& b) { return a.off < b.off; });
  for (const Tile& tl : tiles) {
    const int rc = raw_decode(d, n, (size_t)tl.off, im, tl.x0, tl.y0, tl.xs, tl.ys, *tl.u,
                              tl.stride, 1);
    if (rc) return rc;
  }
  return kOk;
}

// PIL's raw mode on its libtiff route (TiffImagePlugin._setup, PIL's view)
const UnpackerDef* tiff_libtiff_unpacker(const TiffInfo& t, int& rc) {
  // libtiff undoes the fill order itself: PIL takes the fill-order-1 key
  const OpenInfo* key = t.key;
  rc = kOk;
  if (t.fill == 2) {
    key = open_info(key->order, key->photo, t.sf, 1, t.bps, t.extra);
    if (!key) {
      rc = kTiffMode;
      return nullptr;
    }
  }
  std::string raw = key->raw;
  // new-style JPEG YCbCr on one plane: libjpeg converts it to RGB
  if (t.photo == 6 && t.compression == 7 && t.planar == 1) raw = "RGB";
  else if (raw == "I;16") raw = "I;16N";
  else if (raw.size() > 4 && (raw.compare(raw.size() - 4, 4, ";16B") == 0 ||
                              raw.compare(raw.size() - 4, 4, ";16L") == 0))
    raw.back() = 'N';
  const UnpackerDef* u = find_unpacker(t.mode, raw);
  if (!u) rc = kTiffRawMode;
  return u;
}

// TiffDecode.c's _decodeStrip / _decodeTile: libtiff decodes by its view
// (lt), PIL unpacks by its mode and raw mode (t)
int decode_tiff_codec(const uint8_t* d, size_t n, const TiffInfo& t, const TiffInfo& lt,
                      PilImage& im) {
  const TiffIfd& f = lt.ifd;
  int rc;
  const UnpackerDef* u = tiff_libtiff_unpacker(t, rc);
  if (!u) return rc;
  const int bits = (int)lt.bps[0];
  const bool tiled = tiff_libtiff_tiled(f);
  // TiffDecode.c reads separate planes band by band only for modes of more
  // than one band; a palette image with an extra plane ("PX") it unpacks as
  // chunky from the first plane, past the end of each tile's rows: refused
  if (lt.planar == 2 && lt.spp > 1 && pil_bands(t.mode) == 1) return kTiffRawMode;
  const bool separate = lt.planar == 2 && lt.spp > 1;
  if (separate && ((bits != 8 && bits != 16) || (!tiled && u->bits != pil_bands(t.mode) * bits)))
    return kCorrupt;  // TiffDecode.c refuses the layout
  const int planes = separate ? pil_bands(t.mode) : 1;
  const int spp_plane = lt.planar == 2 ? 1 : lt.spp;  // samples per pixel in a stored plane
  std::vector<uint64_t> offs, counts;
  int64_t sw, sh;
  const int stored_planes = lt.planar == 2 ? lt.spp : 1;
  if (!tiff_libtiff_layout(d, n, f, t.xsize, t.ysize, sw, sh, offs, counts, stored_planes))
    return kCorrupt;
  const int64_t across = (t.xsize + sw - 1) / sw, down = (t.ysize + sh - 1) / sh;
  const int64_t per_plane = across * down;
  // _decodeStrip: TIFFScanlineSize must be the unpacker's row to the byte;
  // _decodeTile: TIFFTileSize may not pass ((length * bits / planes + 7) /
  // 8) * width (sic), and an unpacker's row longer than TIFFTileRowSize
  // reads the next row, and past the tile buffer at a tile's last row
  const size_t row_bytes = ((size_t)sw * spp_plane * bits + 7) / 8;
  const size_t unpacker_bytes = ((size_t)sw * u->bits / planes + 7) / 8;
  if (tiled) {
    if ((size_t)sh * row_bytes > ((size_t)sh * u->bits / planes + 7) / 8 * (size_t)sw)
      return kCorrupt;
    if (!separate && unpacker_bytes > row_bytes) return kTiffRawMode;
  } else {
    if (!separate && row_bytes != unpacker_bytes) return kCorrupt;
    // a RowsPerStrip past 2^31 - 1 (but 2^32 - 1, the image's height) is
    // _decodeStrip's memory error (probed)
    const uint64_t rps = f.get(kTagRowsPerStrip, 0xFFFFFFFFu);
    if (rps != 0xFFFFFFFFu && rps > 0x7FFFFFFFu) return kCorrupt;
  }
  // Pillow's strip or tile buffer: what a segment's decoder leaves unwritten
  // reads as the previous segment left it
  std::vector<std::vector<uint8_t>> seg(planes);
  FaxCodec fax;
  for (int64_t s = 0; s < per_plane; ++s) {
    const int x0 = (int)((s % across) * sw), y0 = (int)((s / across) * sh);
    const size_t rows = tiled ? (size_t)sh : (size_t)std::min<int64_t>(sh, t.ysize - y0);
    TiffSeg sg;
    sg.w = (int)sw;
    sg.h = (int)rows;
    sg.last = !tiled && y0 + (int64_t)rows >= t.ysize;
    sg.separate = t.planar == 2;
    sg.tile = tiled;
    sg.fax = &fax;
    for (int p = 0; p < planes; ++p) {
      rc = tiff_segment(d, n, lt, offs[p * per_plane + s], counts[p * per_plane + s], rows,
                        row_bytes, spp_plane, bits, seg[p], sg);
      if (rc) return rc;
    }
    const int xs = (int)std::min<int64_t>(sw, t.xsize - x0);
    const int ys = (int)std::min<int64_t>((int64_t)rows, t.ysize - y0);
    for (int r = 0; r < ys; ++r) {
      if (!separate) {
        unpack(u->op, im.at(x0, y0 + r), seg[0].data() + r * row_bytes, xs);
        continue;
      }
      for (int p = 0; p < planes; ++p) {  // "R", "G", "B", "A" (";16N": the high byte)
        const uint8_t* src = seg[p].data() + r * row_bytes + (bits == 16 ? 1 : 0);
        uint8_t* dst = im.at(x0, y0 + r) + p;
        for (int xx = 0; xx < xs; ++xx) dst[4 * xx] = src[(size_t)xx * (bits / 8)];
      }
    }
  }
  if (separate && t.mode == kModeRGBA) {
    // libtiff names a sample past the colour channels "unspecified" where
    // ExtraSamples does not describe it, and reads Corel Draw's 999 as
    // unassociated alpha
    const std::vector<uint64_t> ex = f.tuple(kTagExtra, {});
    const uint64_t first = ex.empty() ? 0 : ex[0] == 999 ? 2 : ex[0];
    if (first == 0 || first == 1)
      for (int y = 0; y < t.ysize; ++y)
        for (int x = 0; x < t.xsize; ++x) {
          uint8_t* q = im.at(x, y);
          unpremultiply(q, q[0], q[1], q[2], q[3]);
        }
  }
  return kOk;
}

#include "native_tiff_ycbcr.h"

// ImageOps.exif_transpose's Image.transpose: 2 FLIP_LEFT_RIGHT, 3 ROTATE_180,
// 4 FLIP_TOP_BOTTOM, 5 TRANSPOSE, 6 ROTATE_270, 7 TRANSVERSE, 8 ROTATE_90
void tiff_orient(PilImage& im, int orientation) {
  if (orientation < 2 || orientation > 8) return;
  const int W = im.w, H = im.h;
  const bool swap = orientation >= 5;
  const int ow = swap ? H : W, oh = swap ? W : H;
  std::vector<uint8_t> px((size_t)ow * oh * 4);
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int sx, sy;
      switch (orientation) {
        case 2: sx = W - 1 - x; sy = y; break;
        case 3: sx = W - 1 - x; sy = H - 1 - y; break;
        case 4: sx = x; sy = H - 1 - y; break;
        case 5: sx = y; sy = x; break;
        case 6: sx = y; sy = H - 1 - x; break;
        case 7: sx = W - 1 - y; sy = H - 1 - x; break;
        default: sx = W - 1 - y; sy = x; break;  // 8
      }
      std::memcpy(&px[((size_t)y * ow + x) * 4], im.at(sx, sy), 4);
    }
  im.px.swap(px);
  im.w = ow;
  im.h = oh;
}

int decode_tiff(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  TiffInfo t;
  int rc = tiff_setup(d, n, t);
  if (rc) return rc;
  w = t.w;
  h = t.h;
  if (t.mode == kModeLAB) return kTiffLab;
  PilImage im;
  if (t.compression == 1) {  // PIL's raw decoder, by PIL's view alone
    im.alloc(t.mode, t.xsize, t.ysize);  // the stored size (PIL's _tile_size)
    if (t.mode == kModeP || t.mode == kModePA) {
      if ((rc = tiff_palette(t, im))) return rc;
    }
    if ((rc = decode_tiff_raw(d, n, t, im))) return rc;
    if (t.xmp_fails) return kCorrupt;  // "cannot use a bytes pattern on a string-like object"
    tiff_orient(im, t.orientation);
    return pil_to_gray(im, gray);
  }
  TiffInfo lt;
  if ((rc = tiff_libtiff_view(t, lt))) return rc;
  switch (lt.compression) {
    case 50001: return kTiffWebp;
    case 34676: case 34677: return kTiffSgiLog;
    default: break;
  }
  // libtiff's codecs: JPEG of 8-bit samples (12-bit gray has a mode in PIL,
  // whose libtiff hands it 16-bit words), CCITT of 1-bit ones
  for (uint64_t b : lt.bps) {
    if (lt.compression == 7 && b != 8) return b == 12 ? kTiffJpeg : kCorrupt;
    if (is_ccitt(lt.compression) && b != 1) return kCorrupt;  // "Bits/sample must be 1"
  }
  if (t.xmp_fails) return kCorrupt;
  im.alloc(t.mode, t.xsize, t.ysize);
  if (t.mode == kModeP || t.mode == kModePA) {
    if ((rc = tiff_palette(t, im))) return rc;
  }
  // TiffDecode.c reads YCbCr through TIFFRGBAImage, but lets libjpeg convert
  // new-style JPEG on one plane; PIL's raw mode unpacks the RGBA words
  const bool rgba = lt.photo == 6 && !(lt.compression == 7 && lt.planar == 1);
  if (rgba) {
    const UnpackerDef* u = tiff_libtiff_unpacker(t, rc);
    if (!u) return rc;
    PilImage words;
    words.alloc(kModeRGBA, t.xsize, t.ysize);
    if ((rc = decode_tiff_rgba(d, n, lt, words))) return rc;
    for (int y = 0; y < t.ysize; ++y) unpack(u->op, im.at(0, y), words.at(0, y), t.xsize);
  } else if ((rc = decode_tiff_codec(d, n, t, lt, im))) {
    return rc;
  }
  tiff_orient(im, t.orientation);
  return pil_to_gray(im, gray);
}
