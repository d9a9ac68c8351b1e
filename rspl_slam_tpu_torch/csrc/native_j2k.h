// JPEG 2000 (ISO/IEC 15444-1) as PIL 12.1 reads it, then convert("L").
//
// The open is Jpeg2KImagePlugin's: a codestream (FF4F FF51) takes its size
// and mode from SIZ (one component: L, or I;16 past 8 bits; 2 LA; 3 RGB;
// 4 RGBA; another count a SyntaxError), then _parse_comment walks the
// markers up to the first SOT; a JP2 file takes them from its jp2h box
// (ihdr, colr's CMYK, pclr's palette: mode P or PA) through BoxReader,
// then reads past the jp2c box's SIZ. Where the open raises an error
// Image.open takes for "not this format", the file is passed on.
//
// The load is OpenJPEG 2.5.4 as Pillow's Jpeg2KDecode.c drives it (reduce
// and layers 0, strict mode): opj_read_header (the JP2 boxes, then the
// main header), then per tile opj_read_tile_header (every tile-part of
// the tile) and opj_decode_tile_data: tier-2 packet headers in the tile's
// progression (POCs included; SOP/EPH, PPM/PPT), tier-1 code-blocks (the
// MQ decoder with OpenJPEG's synthetic 0xFFFF end marker, the three
// passes, the half-step reconstruction halved), RGN's max-shift, the
// inverse 5/3 wavelet, the RCT, the DC level shift and clamp, written out
// as opj_tcd_update_tile_data does; Pillow's unpacker then fills the
// image of the mode it opened. Where OpenJPEG fails, the file fails
// (IOError), as PIL's "broken data stream" does.
//
// Code-blocks of every style bit but HT decode as OpenJPEG decodes them
// (BYPASS's raw passes, RESET, TERMALL's segment a pass, VSC's stripe-causal
// contexts, PTERM, SEGSYM's four symbols). Refused by name
// (NotImplementedError): the irreversible 9/7 wavelet and its ICT, HT
// (Part 15) code-blocks, and Part 2 markers (MCT, MCC, MCO, CBD).
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h.

// ------------------------------------------------------------- helpers
inline uint32_t j2k_be(const uint8_t* p, int k) {
  uint32_t v = 0;
  for (int i = 0; i < k; ++i) v = (v << 8) | p[i];
  return v;
}
inline int32_t j2k_ceildiv(int64_t a, int64_t b) { return (int32_t)((a + b - 1) / b); }
inline uint32_t j2k_uceildiv(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a + b - 1) / b);
}
inline int32_t j2k_ceildivpow2(int64_t a, int b) {
  return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t j2k_floordivpow2(int32_t a, int b) { return a >> b; }

// ---------------------------------------------------- the PIL open
struct J2kOpen {
  bool jp2 = false;
  int w = 0, h = 0;
  PilMode mode = kModeNone;
  std::vector<uint8_t> palette;  // ImagePalette's bytes, for P and PA
  bool pal_rgba = false;         // an "RGBA" palette (four channels)
};

// BoxReader over d[0, n) from `pos`, as the plugin reads a JP2 header
struct J2kBoxReader {
  const uint8_t* d;
  size_t n;       // the file's (or the box's) length
  size_t pos;     // the file position
  bool has_length;
  int64_t remaining = -1;
  size_t base = 0;  // where this reader's BytesIO starts in d
  // "Not enough data in header" (SyntaxError) and "Expected to read"
  // (OSError) as kPassOn / kCorrupt
  int can_read(int64_t k) const {
    if (has_length && (int64_t)(pos - base) + k > (int64_t)n) return 0;
    if (remaining >= 0) return k <= remaining;
    return 1;
  }
  int read(size_t k, const uint8_t*& out) {
    if (!can_read((int64_t)k)) return kPassOn;
    if (pos > base + n || k > base + n - pos) return kCorrupt;
    out = d + pos;
    pos += k;
    if (remaining > 0) remaining -= (int64_t)k;
    return kOk;
  }
  bool has_next() const { return has_length ? (int64_t)(pos - base) + remaining < (int64_t)n : true; }
  int next_box(uint32_t& type) {
    if (remaining > 0) pos += (size_t)remaining;  // fp.seek: may pass the end
    remaining = -1;
    const uint8_t* p;
    int rc = read(8, p);
    if (rc) return rc;
    uint64_t lbox = j2k_be(p, 4);
    type = j2k_be(p + 4, 4);
    int hlen = 8;
    if (lbox == 1) {
      if ((rc = read(8, p))) return rc;
      lbox = ((uint64_t)j2k_be(p, 4) << 32) | j2k_be(p + 4, 4);
      hlen = 16;
    }
    if (lbox < (uint64_t)hlen || !can_read((int64_t)(lbox - hlen))) return kPassOn;  // "Invalid header length"
    remaining = (int64_t)(lbox - hlen);
    return kOk;
  }
};

// _parse_jp2_header from d[12:]
int j2k_parse_jp2_header(const uint8_t* d, size_t n, J2kOpen& o, size_t& after) {
  J2kBoxReader r{d, n, 12, false};
  bool found = false;
  size_t hdr_at = 0, hdr_len = 0;
  int rc;
  while (r.has_next()) {
    uint32_t t;
    if ((rc = r.next_box(t))) return rc;
    if (t == 0x6a703268) {  // jp2h: read_boxes
      const uint8_t* p;
      const size_t size = (size_t)r.remaining;
      if ((rc = r.read(size, p))) return rc;
      hdr_at = (size_t)(p - d);
      hdr_len = size;
      found = true;
      break;
    } else if (t == 0x66747970) {  // ftyp
      const uint8_t* p;
      if ((rc = r.read(4, p))) return rc;
    }
  }
  if (!found) return kCorrupt;  // assert header is not None
  after = r.pos;
  J2kBoxReader h{d, hdr_len, hdr_at, true};
  h.base = hdr_at;
  int64_t nc = -1;
  bool have_size = false;
  PilMode mode = kModeNone;
  while (h.has_next()) {
    uint32_t t;
    if ((rc = h.next_box(t))) return rc;
    const uint8_t* p;
    if (t == 0x69686472) {  // ihdr
      if ((rc = h.read(11, p))) return rc;
      const uint32_t height = j2k_be(p, 4), width = j2k_be(p + 4, 4);
      nc = j2k_be(p + 8, 2);
      const int bpc = p[10];
      o.w = (int)std::min<uint32_t>(width, 0x7fffffff);
      o.h = (int)std::min<uint32_t>(height, 0x7fffffff);
      if (width > 0x7fffffffu || height > 0x7fffffffu) return kCorrupt;
      have_size = true;
      if (nc == 1 && (bpc & 0x7f) > 8) mode = kModeI16;
      else if (nc == 1) mode = kModeL;
      else if (nc == 2) mode = kModeLA;
      else if (nc == 3) mode = kModeRGB;
      else if (nc == 4) mode = kModeRGBA;
    } else if (t == 0x636f6c72 && nc == 4) {  // colr
      if ((rc = h.read(7, p))) return rc;
      if (p[0] == 1 && j2k_be(p + 3, 4) == 12) mode = kModeCMYK;
    } else if (t == 0x70636c72 && (mode == kModeL || mode == kModeLA)) {  // pclr
      if ((rc = h.read(3, p))) return rc;
      const int ne = (int)j2k_be(p, 2), npc = p[2];
      if ((rc = h.read((size_t)npc, p))) return rc;
      int maxbd = 0;
      for (int i = 0; i < npc; ++i) maxbd = std::max(maxbd, (int)p[i]);
      if (maxbd <= 8) {
        // ImagePalette.getcolor: each new colour appended, a repeat
        // reusing its index; an RGB palette takes an opaque RGBA colour's
        // first three values
        const bool rgba = npc == 4;
        std::vector<std::vector<uint8_t>> seen;
        std::vector<uint8_t> pal;
        for (int i = 0; i < ne; ++i) {
          if ((rc = h.read((size_t)npc, p))) return rc;
          std::vector<uint8_t> c(p, p + npc);
          if (!rgba && npc == 4) {
            if (c[3] != 255) return kCorrupt;  // "cannot add non-opaque RGBA color to RGB palette"
            c.resize(3);
          } else if (rgba && npc == 3) {
            c.push_back(255);
          }
          bool dup = false;
          for (const auto& s : seen) dup = dup || s == c;
          if (dup) continue;
          if (seen.size() >= 256) return kCorrupt;  // "cannot allocate more than 256 colors"
          seen.push_back(c);
          pal.insert(pal.end(), c.begin(), c.end());
        }
        o.palette = pal;
        o.pal_rgba = rgba;
        mode = mode == kModeL ? kModeP : kModePA;
      }
    } else if (t == 0x72657320) {  // res: its boxes, to the first resc
      const size_t size = (size_t)h.remaining;
      if ((rc = h.read(size, p))) return rc;
      J2kBoxReader res{d, size, (size_t)(p - d), true};
      res.base = (size_t)(p - d);
      while (res.has_next()) {
        uint32_t tr;
        if ((rc = res.next_box(tr))) return rc;
        if (tr == 0x72657363) {
          const uint8_t* q;
          if ((rc = res.read(10, q))) return rc;
          break;
        }
      }
    }
  }
  if (!have_size || mode == kModeNone) return kPassOn;  // "Malformed JP2 header"
  o.mode = mode;
  return kOk;
}

// Jpeg2KImageFile._open (and ImageFile's size check); kPassOn where
// Image.open goes on to the next plugin
int j2k_pil_open(const uint8_t* d, size_t n, J2kOpen& o) {
  if (n < 4) return kPassOn;
  auto parse_comment = [&](size_t pos) {
    // _parse_comment: markers to SOT or EOC, each skipped by its length
    while (true) {
      if (pos >= n) return kOk;
      if (pos + 2 > n) return kPassOn;  // marker[1] of one byte: IndexError
      const int typ = d[pos + 1];
      pos += 2;
      if (typ == 0x90 || typ == 0xD9) return kOk;
      if (pos + 2 > n) return kPassOn;  // i16be: struct.error
      const int64_t len = (int64_t)j2k_be(d + pos, 2);
      pos += 2;
      // fp.read(length - 2) on a file: a count below -1 raises ValueError
      if (typ == 0x64) return len == 0 ? kCorrupt : kOk;
      const int64_t np = (int64_t)pos + len - 2;
      if (np < 0) return kCorrupt;  // a negative seek: ValueError
      pos = (size_t)np;
    }
  };
  if (!std::memcmp(d, "\xff\x4f\xff\x51", 4)) {
    // _parse_codestream
    if (n < 6) return kPassOn;
    const uint32_t lsiz = j2k_be(d + 4, 2);
    if (lsiz == 0) return kCorrupt;  // fp.read(-2) on a file: ValueError
    const size_t have = lsiz < 2 ? n - 4 : std::min<size_t>(n - 4, lsiz);
    if (have < 38) return kPassOn;  // unpack_from: struct.error
    const uint8_t* s = d + 4;
    const int64_t xsiz = j2k_be(s + 4, 4), ysiz = j2k_be(s + 8, 4);
    const int64_t xo = j2k_be(s + 12, 4), yo = j2k_be(s + 16, 4);
    const int csiz = (int)j2k_be(s + 36, 2);
    if (csiz == 1) {
      if (have < 39) return kPassOn;
      o.mode = (s[38] & 0x7f) + 1 > 8 ? kModeI16 : kModeL;
    } else if (csiz == 2) {
      o.mode = kModeLA;
    } else if (csiz == 3) {
      o.mode = kModeRGB;
    } else if (csiz == 4) {
      o.mode = kModeRGBA;
    } else {
      return kPassOn;  // "unable to determine J2K image mode"
    }
    if (xsiz - xo <= 0 || ysiz - yo <= 0) return kPassOn;  // "not identified by this driver"
    o.w = (int)std::min<int64_t>(xsiz - xo, 0x7fffffff);
    o.h = (int)std::min<int64_t>(ysiz - yo, 0x7fffffff);
    // the SIZ read as fp.read(lsiz - 2): a negative length reads to the end
    const size_t after = lsiz < 2 ? n : std::min<size_t>(n, 6 + (size_t)lsiz - 2);
    const int rc = parse_comment(after);
    if (rc) return rc;
    o.jp2 = false;
  } else {
    if (n < 12 || std::memcmp(d, "\0\0\0\x0cjP  \x0d\x0a\x87\x0a", 12)) return kPassOn;
    size_t after = 0;
    int rc = j2k_parse_jp2_header(d, n, o, after);
    if (rc) return rc;
    if (o.w <= 0 || o.h <= 0) return kPassOn;
    // fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51")
    if (after <= n && n - after >= 12 && !std::memcmp(d + after + 4, "jp2c\xff\x4f\xff\x51", 8)) {
      size_t pos = after + 12;
      if (pos + 2 > n) return kPassOn;
      const int64_t len = j2k_be(d + pos, 2);
      pos += 2;
      const int64_t np = (int64_t)pos + len - 2;
      if (np < 0) return kCorrupt;
      if ((rc = parse_comment((size_t)np))) return rc;
    }
    o.jp2 = true;
  }
  if ((uint64_t)o.w * (uint64_t)o.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  return kOk;
}

// ------------------------------------------------ OpenJPEG's model
struct J2kTccp {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  uint32_t qntsty = 0, numgbits = 0, roishift = 0;
  uint32_t prcw[33] = {0}, prch[33] = {0};
  int32_t expn[97] = {0};
  int32_t dc_shift = 0;
};

struct J2kPoc {
  uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
  int prg = 0;
};

struct J2kTcp {
  uint32_t csty = 0, numlayers = 0, mct = 0;
  int prg = 0;
  std::vector<J2kTccp> tccps;
  bool poc = false;
  std::vector<J2kPoc> pocs;
  bool ppt = false;
  std::map<int, std::vector<uint8_t>> ppt_markers;
  std::vector<uint8_t> ppt_data;
  size_t ppt_pos = 0;
  int cur_part = -1;
  uint32_t nb_parts = 0;
  bool has_data = false;
  std::vector<uint8_t> data;
};

struct J2kComp {
  uint32_t prec = 0, dx = 1, dy = 1;
  bool sgnd = false;
  uint32_t resno_decoded = 0;
};

struct J2kCodec {
  const uint8_t* d;
  size_t n;       // the stream's length (the whole file)
  size_t pos;     // where OpenJPEG reads next
  // the refusal found on the way (a feature the port does not read)
  int refused = 0;
  // the image
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t tdx = 0, tdy = 0, tx0 = 0, ty0 = 0, tw = 0, th = 0;
  std::vector<J2kComp> comps;
  J2kTcp def;
  std::vector<J2kTcp> tcps;
  bool ppm = false;
  std::map<int, std::vector<uint8_t>> ppm_markers;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;
  // JP2
  uint32_t ihdr_w = 0, ihdr_h = 0;
  int color_space = 0;  // OPJ_CLRSPC_*: 0 unspecified, 1 sRGB, 2 gray, 3 sYCC, 4 eYCC, 5 CMYK
  // decoder state
  enum { kMHSOC = 1, kMHSIZ = 2, kMH = 4, kTPHSOT = 8, kTPH = 16, kMT = 32, kNEOC = 64,
         kDATA = 128, kEOC = 256 };
  uint32_t state = 0;
  uint32_t cur_tile = 0;
  int64_t sot_length = 0;
  bool last_tile_part = false, can_decode = false;

  size_t left() const { return pos < n ? n - pos : 0; }
  bool read(size_t k, const uint8_t*& p) {
    if (left() < k) {
      pos = n;
      return false;
    }
    p = d + pos;
    pos += k;
    return true;
  }
  J2kTcp& cur_tcp() { return (state == kTPH) ? tcps[cur_tile] : def; }
};

// the marker handlers' states (opj_j2k_memory_marker_handler_tab); 0 for
// a marker the table does not know (J2K_MS_UNK)
uint32_t j2k_marker_states(uint32_t m, bool& known) {
  known = true;
  switch (m) {
    case 0xFF90: return J2kCodec::kMH | J2kCodec::kTPHSOT;
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D: case 0xFF5F: case 0xFF64:
    case 0xFF74: case 0xFF75: case 0xFF77:
      return J2kCodec::kMH | J2kCodec::kTPH;
    case 0xFF51: return J2kCodec::kMHSIZ;
    case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78: case 0xFF50: case 0xFF59:
      return J2kCodec::kMH;
    case 0xFF58: case 0xFF61: return J2kCodec::kTPH;
    case 0xFF91: return 0;
    default:
      known = false;
      return J2kCodec::kMH | J2kCodec::kTPH;
  }
}

// opj_j2k_read_siz
bool j2k_read_siz(J2kCodec& c, const uint8_t* p, uint32_t size) {
  if (size < 36 || (size - 36) % 3) return false;
  const uint32_t nb = (size - 36) / 3;
  c.x1 = j2k_be(p + 2, 4);
  c.y1 = j2k_be(p + 6, 4);
  c.x0 = j2k_be(p + 10, 4);
  c.y0 = j2k_be(p + 14, 4);
  c.tdx = j2k_be(p + 18, 4);
  c.tdy = j2k_be(p + 22, 4);
  c.tx0 = j2k_be(p + 26, 4);
  c.ty0 = j2k_be(p + 30, 4);
  const uint32_t csiz = j2k_be(p + 34, 2);
  if (csiz >= 16385 || csiz != nb) return false;
  if (c.x0 >= c.x1 || c.y0 >= c.y1) return false;
  if (c.tdx == 0 || c.tdy == 0) return false;
  const uint32_t tx1 = (uint32_t)std::min<uint64_t>((uint64_t)c.tx0 + c.tdx, 0xFFFFFFFFu);
  const uint32_t ty1 = (uint32_t)std::min<uint64_t>((uint64_t)c.ty0 + c.tdy, 0xFFFFFFFFu);
  if (c.tx0 > c.x0 || c.ty0 > c.y0 || tx1 <= c.x0 || ty1 <= c.y0) return false;
  if (c.ihdr_w > 0 && c.ihdr_h > 0 && (c.ihdr_w != c.x1 - c.x0 || c.ihdr_h != c.y1 - c.y0))
    return false;
  c.comps.assign(csiz, J2kComp());
  for (uint32_t i = 0; i < csiz; ++i) {
    const uint8_t* q = p + 36 + 3 * i;
    J2kComp& k = c.comps[i];
    k.prec = (q[0] & 0x7f) + 1u;
    k.sgnd = q[0] >> 7;
    k.dx = q[1];
    k.dy = q[2];
    if (k.dx < 1 || k.dy < 1) return false;
    if (k.prec > 31) return false;
  }
  c.tw = j2k_uceildiv(c.x1 - c.tx0, c.tdx);
  c.th = j2k_uceildiv(c.y1 - c.ty0, c.tdy);
  if (c.tw == 0 || c.th == 0 || c.tw > 65535 / c.th) return false;
  c.def.tccps.assign(csiz, J2kTccp());
  for (uint32_t i = 0; i < csiz; ++i)
    if (!c.comps[i].sgnd) c.def.tccps[i].dc_shift = 1 << (c.comps[i].prec - 1);
  c.tcps.assign((size_t)c.tw * c.th, J2kTcp());
  for (auto& t : c.tcps) t.tccps.assign(csiz, J2kTccp());
  c.state = J2kCodec::kMH;
  return true;
}

// opj_j2k_read_SPCod_SPCoc
bool j2k_read_spcod(J2kCodec& c, J2kTcp& t, uint32_t compno, const uint8_t*& p, uint32_t& size) {
  J2kTccp& k = t.tccps[compno];
  if (size < 5) return false;
  k.numres = p[0] + 1u;
  if (k.numres > 33) return false;
  k.cblkw = p[1] + 2u;
  k.cblkh = p[2] + 2u;
  if (k.cblkw > 10 || k.cblkh > 10 || k.cblkw + k.cblkh > 12) return false;
  k.cblksty = p[3];
  if (k.cblksty & 0x80) return false;  // mixed HT
  k.qmfbid = p[4];
  if (k.qmfbid > 1) return false;
  p += 5;
  size -= 5;
  if (k.csty & 1) {
    if (size < k.numres) return false;
    for (uint32_t i = 0; i < k.numres; ++i) {
      const uint32_t v = p[i];
      if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) return false;  // "Invalid precinct size"
      k.prcw[i] = v & 0xf;
      k.prch[i] = v >> 4;
    }
    p += k.numres;
    size -= k.numres;
  } else {
    for (uint32_t i = 0; i < k.numres; ++i) k.prcw[i] = k.prch[i] = 15;
  }
  (void)c;
  return true;
}

bool j2k_read_cod(J2kCodec& c, const uint8_t* p, uint32_t size) {
  J2kTcp& t = c.cur_tcp();
  if (size < 5) return false;
  t.csty = p[0];
  if (t.csty & ~7u) return false;  // "Unknown Scod value"
  t.prg = p[1] > 4 ? -1 : p[1];
  t.numlayers = j2k_be(p + 2, 2);
  if (t.numlayers < 1) return false;
  t.mct = p[4];
  if (t.mct > 1) return false;
  size -= 5;
  p += 5;
  for (auto& k : t.tccps) k.csty = t.csty & 1;
  if (!j2k_read_spcod(c, t, 0, p, size)) return false;
  if (size != 0) return false;
  // opj_j2k_copy_tile_component_parameters: component 0's to the others
  for (size_t i = 1; i < t.tccps.size(); ++i) {
    J2kTccp& k = t.tccps[i];
    const J2kTccp& z = t.tccps[0];
    k.numres = z.numres;
    k.cblkw = z.cblkw;
    k.cblkh = z.cblkh;
    k.cblksty = z.cblksty;
    k.qmfbid = z.qmfbid;
    std::memcpy(k.prcw, z.prcw, sizeof(k.prcw));
    std::memcpy(k.prch, z.prch, sizeof(k.prch));
  }
  return true;
}

bool j2k_read_coc(J2kCodec& c, const uint8_t* p, uint32_t size) {
  J2kTcp& t = c.cur_tcp();
  const uint32_t room = c.comps.size() <= 256 ? 1 : 2;
  if (size < room + 1) return false;
  size -= room + 1;
  const uint32_t compno = j2k_be(p, (int)room);
  p += room;
  if (compno >= c.comps.size()) return false;
  t.tccps[compno].csty = p[0];
  ++p;
  if (!j2k_read_spcod(c, t, compno, p, size)) return false;
  return size == 0;
}

// opj_j2k_read_SQcd_SQcc
bool j2k_read_sqcd(J2kTcp& t, uint32_t compno, const uint8_t*& p, uint32_t& size) {
  J2kTccp& k = t.tccps[compno];
  if (size < 1) return false;
  size -= 1;
  const uint32_t v = p[0];
  ++p;
  k.qntsty = v & 0x1f;
  k.numgbits = v >> 5;
  uint32_t nb;
  if (k.qntsty == 1) nb = 1;
  else nb = k.qntsty == 0 ? size : size / 2;
  if (k.qntsty == 0) {
    for (uint32_t b = 0; b < nb; ++b) {
      if (b < 97) k.expn[b] = (int32_t)(p[b] >> 3);
    }
    if (size < nb) return false;
    p += nb;
    size -= nb;
  } else {
    if (size < 2 * nb) return false;
    for (uint32_t b = 0; b < nb; ++b) {
      if (b < 97) k.expn[b] = (int32_t)(j2k_be(p + 2 * b, 2) >> 11);
    }
    p += 2 * nb;
    size -= 2 * nb;
  }
  if (k.qntsty == 1)
    for (uint32_t b = 1; b < 97; ++b)
      k.expn[b] = k.expn[0] - (int32_t)((b - 1) / 3) > 0 ? k.expn[0] - (int32_t)((b - 1) / 3) : 0;
  return true;
}

bool j2k_read_qcd(J2kCodec& c, const uint8_t* p, uint32_t size) {
  J2kTcp& t = c.cur_tcp();
  if (!j2k_read_sqcd(t, 0, p, size) || size != 0) return false;
  for (size_t i = 1; i < t.tccps.size(); ++i) {
    t.tccps[i].qntsty = t.tccps[0].qntsty;
    t.tccps[i].numgbits = t.tccps[0].numgbits;
    std::memcpy(t.tccps[i].expn, t.tccps[0].expn, sizeof(t.tccps[0].expn));
  }
  return true;
}

bool j2k_read_qcc(J2kCodec& c, const uint8_t* p, uint32_t size) {
  J2kTcp& t = c.cur_tcp();
  uint32_t compno;
  if (c.comps.size() <= 256) {
    if (size < 1) return false;
    compno = p[0];
    ++p;
    --size;
  } else {
    if (size < 2) return false;
    compno = j2k_be(p, 2);
    p += 2;
    size -= 2;
  }
  if (compno >= c.comps.size()) return false;
  return j2k_read_sqcd(t, compno, p, size) && size == 0;
}

bool j2k_read_rgn(J2kCodec& c, const uint8_t* p, uint32_t size) {
  const uint32_t room = c.comps.size() <= 256 ? 1 : 2;
  if (size != 2 + room) return false;
  J2kTcp& t = c.cur_tcp();
  const uint32_t compno = j2k_be(p, (int)room);
  if (compno >= c.comps.size()) return false;
  t.tccps[compno].roishift = p[room + 1];
  return true;
}

bool j2k_read_poc(J2kCodec& c, const uint8_t* p, uint32_t size) {
  const uint32_t room = c.comps.size() <= 256 ? 1 : 2;
  const uint32_t chunk = 5 + 2 * room;
  const uint32_t k = size / chunk;
  if (k == 0 || size % chunk) return false;
  J2kTcp& t = c.cur_tcp();
  const uint32_t old = t.poc ? (uint32_t)t.pocs.size() : 0;
  if (old + k >= 32) return false;  // "Too many POCs"
  t.poc = true;
  t.pocs.resize(old);
  for (uint32_t i = 0; i < k; ++i) {
    J2kPoc q;
    q.resno0 = p[0];
    q.compno0 = j2k_be(p + 1, (int)room);
    q.layno1 = std::min<uint32_t>(j2k_be(p + 1 + room, 2), t.numlayers);
    q.resno1 = p[3 + room];
    q.compno1 = std::min<uint32_t>(j2k_be(p + 4 + room, (int)room), (uint32_t)c.comps.size());
    q.prg = p[4 + 2 * room];
    t.pocs.push_back(q);
    p += chunk;
  }
  return true;
}

bool j2k_read_tlm(const uint8_t* p, uint32_t size) {
  if (size < 2) return false;
  size -= 2;
  const uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
  if (st == 3) return false;
  const uint32_t q = (sp + 1) * 2 + st;
  return size % q == 0;
}

bool j2k_read_plt(const uint8_t* p, uint32_t size) {
  if (size < 1) return false;
  uint32_t len = 0;
  for (uint32_t i = 1; i < size; ++i) {
    len |= p[i] & 0x7f;
    if (p[i] & 0x80) len <<= 7;
    else len = 0;
  }
  return len == 0;
}

bool j2k_read_ppm(J2kCodec& c, const uint8_t* p, uint32_t size) {
  if (size < 2) return false;
  c.ppm = true;
  const int z = p[0];
  if (c.ppm_markers.count(z)) return false;  // "Zppm already read"
  c.ppm_markers[z].assign(p + 1, p + size);
  return true;
}

bool j2k_read_ppt(J2kCodec& c, const uint8_t* p, uint32_t size) {
  if (size < 2) return false;
  if (c.ppm) return false;
  J2kTcp& t = c.tcps[c.cur_tile];
  t.ppt = true;
  const int z = p[0];
  if (t.ppt_markers.count(z)) return false;
  t.ppt_markers[z].assign(p + 1, p + size);
  return true;
}

// opj_j2k_merge_ppm: the Ippm data of every marker in Zppm order, each
// Nppm's share
bool j2k_merge_ppm(J2kCodec& c) {
  if (!c.ppm) return true;
  uint64_t remaining = 0;
  c.ppm_data.clear();
  for (auto& kv : c.ppm_markers) {
    const std::vector<uint8_t>& m = kv.second;
    size_t at = 0, size = m.size();
    if (remaining >= size) {
      c.ppm_data.insert(c.ppm_data.end(), m.begin(), m.end());
      remaining -= size;
      continue;
    }
    c.ppm_data.insert(c.ppm_data.end(), m.begin(), m.begin() + (size_t)remaining);
    at = (size_t)remaining;
    size -= (size_t)remaining;
    remaining = 0;
    while (size > 0) {
      if (size < 4) return false;  // "Not enough bytes to read Nppm"
      const uint32_t nppm = j2k_be(m.data() + at, 4);
      at += 4;
      size -= 4;
      if (size >= nppm) {
        c.ppm_data.insert(c.ppm_data.end(), m.begin() + at, m.begin() + at + nppm);
        at += nppm;
        size -= nppm;
      } else {
        c.ppm_data.insert(c.ppm_data.end(), m.begin() + at, m.end());
        remaining = nppm - size;
        size = 0;
      }
    }
  }
  return remaining == 0;  // "Corrupted PPM markers"
}

// read a main or tile-part header marker's segment with its handler;
// false where OpenJPEG's handler fails
bool j2k_handle(J2kCodec& c, uint32_t m, const uint8_t* p, uint32_t size) {
  switch (m) {
    case 0xFF51: return j2k_read_siz(c, p, size);
    case 0xFF52: return j2k_read_cod(c, p, size);
    case 0xFF53: return j2k_read_coc(c, p, size);
    case 0xFF5C: return j2k_read_qcd(c, p, size);
    case 0xFF5D: return j2k_read_qcc(c, p, size);
    case 0xFF5E: return j2k_read_rgn(c, p, size);
    case 0xFF5F: return j2k_read_poc(c, p, size);
    case 0xFF55: return j2k_read_tlm(p, size);
    case 0xFF57: return size >= 1;
    case 0xFF58: return j2k_read_plt(p, size);
    case 0xFF60: return j2k_read_ppm(c, p, size);
    case 0xFF61: return j2k_read_ppt(c, p, size);
    case 0xFF63: return size == c.comps.size() * 4;
    case 0xFF64: return true;
    case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78:
      if (!c.refused) c.refused = kJ2kPart2;  // Part 2 multiple component transforms
      return true;
    case 0xFF50: case 0xFF59:
      if (!c.refused) c.refused = kJ2kHt;  // Part 15: CAP, CPF
      return true;
    default: return false;
  }
}

// opj_j2k_read_unk: two bytes at a time to a marker the table knows
bool j2k_read_unk(J2kCodec& c, uint32_t& marker) {
  while (true) {
    const uint8_t* p;
    if (!c.read(2, p)) return false;
    const uint32_t m = j2k_be(p, 2);
    if (m < 0xff00) continue;
    bool known;
    const uint32_t st = j2k_marker_states(m, known);
    if (!(c.state & st)) return false;
    if (known) {
      marker = m;
      return true;
    }
  }
}

// opj_j2k_read_header_procedure
bool j2k_read_main_header(J2kCodec& c) {
  const uint8_t* p;
  c.state = J2kCodec::kMHSOC;
  if (!c.read(2, p) || j2k_be(p, 2) != 0xFF4F) return false;
  c.state = J2kCodec::kMHSIZ;
  if (!c.read(2, p)) return false;
  uint32_t m = j2k_be(p, 2);
  bool siz = false, cod = false, qcd = false;
  while (m != 0xFF90) {
    if (m < 0xff00) return false;
    bool known;
    uint32_t st = j2k_marker_states(m, known);
    if (!known) {
      if (!j2k_read_unk(c, m)) return false;
      if (m == 0xFF90) break;
      st = j2k_marker_states(m, known);
    }
    siz = siz || m == 0xFF51;
    cod = cod || m == 0xFF52;
    qcd = qcd || m == 0xFF5C;
    if (!(c.state & st)) return false;  // "Marker is not compliant with its position"
    if (!c.read(2, p)) return false;
    uint32_t size = j2k_be(p, 2);
    if (size < 2) return false;
    size -= 2;
    if (!c.read(size, p)) return false;
    if (!j2k_handle(c, m, p, size)) return false;
    if (!c.read(2, p)) return false;
    m = j2k_be(p, 2);
  }
  if (!siz || !cod || !qcd) return false;
  if (!j2k_merge_ppm(c)) return false;
  c.state = J2kCodec::kTPHSOT;
  // opj_j2k_copy_default_tcp_and_create_tcd
  for (auto& t : c.tcps) t = c.def;
  return true;
}

// opj_j2k_read_sot
bool j2k_read_sot(J2kCodec& c, const uint8_t* p, uint32_t size) {
  if (size != 8) return false;
  c.cur_tile = j2k_be(p, 2);
  const uint32_t tot = j2k_be(p + 2, 4), part = p[6];
  uint32_t parts = p[7];
  if (c.cur_tile >= c.tw * c.th) return false;
  J2kTcp& t = c.tcps[c.cur_tile];
  if (t.cur_part + 1 != (int)part) return false;  // "Invalid tile part index"
  t.cur_part = (int)part;
  if (tot != 0 && tot < 14 && tot != 12) return false;  // "Psot value is not correct"
  if (!tot) c.last_tile_part = true;
  if (t.nb_parts != 0 && part >= t.nb_parts) {
    c.last_tile_part = true;
    return false;
  }
  if (parts != 0) {
    if (t.nb_parts && part >= t.nb_parts) {
      c.last_tile_part = true;
      return false;
    }
    if (part >= parts) {
      c.last_tile_part = true;
      return false;
    }
    t.nb_parts = parts;
  }
  if (t.nb_parts && t.nb_parts == part + 1) c.can_decode = true;
  c.sot_length = c.last_tile_part ? 0 : (int64_t)tot - 12;
  c.state = J2kCodec::kTPH;
  return true;
}

// opj_j2k_read_sod
bool j2k_read_sod(J2kCodec& c) {
  J2kTcp& t = c.tcps[c.cur_tile];
  if (c.last_tile_part) {
    if (c.left() < 2) return false;  // the length wraps: past the stream
    c.sot_length = (int64_t)c.left() - 2;
  } else if (c.sot_length >= 2) {
    c.sot_length -= 2;
  }
  bool pb = false;
  if (c.sot_length) {
    if (c.sot_length > (int64_t)c.left()) return false;  // strict: "Tile part length size inconsistent"
    t.has_data = true;
  } else {
    pb = true;
  }
  size_t got = 0;
  if (!pb && c.sot_length > 0) {
    got = std::min<size_t>((size_t)c.sot_length, c.left());
    t.data.insert(t.data.end(), c.d + c.pos, c.d + c.pos + got);
    c.pos += got;
  }
  c.state = (int64_t)got != c.sot_length ? J2kCodec::kNEOC : J2kCodec::kTPHSOT;
  return true;
}

// opj_j2k_read_tile_header; returns 1 a tile to decode, 0 none left, -1 an error
int j2k_read_tile_header(J2kCodec& c) {
  uint32_t marker = 0xFF90;
  const uint8_t* p;
  const uint32_t ntiles = c.tw * c.th;
  if (c.state == J2kCodec::kEOC) marker = 0xFFD9;
  else if (c.state != J2kCodec::kTPHSOT) return -1;
  while (!c.can_decode && marker != 0xFFD9) {
    while (marker != 0xFF93) {
      if (c.left() == 0) {
        c.state = J2kCodec::kNEOC;
        break;
      }
      if (!c.read(2, p)) return -1;
      uint32_t size = j2k_be(p, 2);
      if (size < 2) return -1;
      if (marker == 0x8080 && c.left() == 0) {
        c.state = J2kCodec::kNEOC;
        break;
      }
      if ((c.state & J2kCodec::kTPH) && c.sot_length != 0) {
        if (c.sot_length < (int64_t)size + 2) return -1;
        c.sot_length -= size + 2;
      }
      size -= 2;
      bool known;
      const uint32_t st = j2k_marker_states(marker, known);
      if (!(c.state & st)) return -1;  // unknown markers included
      if (!c.read(size, p)) return -1;
      if (!known || marker == 0xFF91) return -1;
      bool ok = marker == 0xFF90 ? j2k_read_sot(c, p, size) : j2k_handle(c, marker, p, size);
      if (!ok) return -1;
      if (!c.read(2, p)) return -1;
      marker = j2k_be(p, 2);
    }
    if (c.left() == 0 && c.state == J2kCodec::kNEOC) break;
    // (opj_j2k_need_nb_tile_parts_correction needs a stream that seeks:
    // Pillow's does not, so no TNsot is ever corrected)
    if (!j2k_read_sod(c)) return -1;
    if (!c.can_decode) {
      if (!c.read(2, p)) {
        if (c.cur_tile + 1 == ntiles) {
          uint32_t k = 0;
          for (; k < ntiles; ++k)
            if (c.tcps[k].cur_part == 0 && c.tcps[k].nb_parts == 0) break;
          if (k < ntiles) {
            c.cur_tile = k;
            marker = 0xFFD9;
            c.state = J2kCodec::kEOC;
            break;
          }
        }
        return -1;
      }
      marker = j2k_be(p, 2);
    }
  }
  if (marker == 0xFFD9 && c.state != J2kCodec::kEOC) {
    c.cur_tile = 0;
    c.state = J2kCodec::kEOC;
  }
  if (!c.can_decode) {
    while (c.cur_tile < ntiles && !c.tcps[c.cur_tile].has_data) ++c.cur_tile;
    if (c.cur_tile == ntiles) return 0;
  }
  // opj_j2k_merge_ppt
  J2kTcp& t = c.tcps[c.cur_tile];
  if (t.ppt) {
    t.ppt_data.clear();
    for (auto& kv : t.ppt_markers) t.ppt_data.insert(t.ppt_data.end(), kv.second.begin(), kv.second.end());
    t.ppt_markers.clear();
    t.ppt_pos = 0;
  }
  c.state |= J2kCodec::kDATA;
  return 1;
}

// ------------------------------------------------------ tile geometry
struct J2kSeg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
           newlen = 0;
};
struct J2kCblk {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numbps = 0, numlenbits = 0, numsegs = 0, real_num_segs = 0, numnewpasses = 0;
  std::vector<J2kSeg> segs;
  std::vector<std::pair<size_t, uint32_t>> chunks;  // (offset in the tile data, length)
};

// opj_tgt tag tree
struct J2kTagTree {
  struct Node { int parent; int32_t value, low; };
  std::vector<Node> nodes;
  void create(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w * h == 0) return;
    std::vector<uint32_t> lw = {w}, lh = {h};
    uint32_t total = 0;
    while (true) {
      const uint32_t k = lw.back() * lh.back();
      total += k;
      if (k <= 1) break;
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    nodes.assign(total, Node{-1, 999, 0});
    uint32_t node = 0, parent = w * h, parent0 = parent;
    for (size_t i = 0; i + 1 < lw.size(); ++i) {
      for (uint32_t j = 0; j < lh[i]; ++j) {
        int32_t k = (int32_t)lw[i];
        while (--k >= 0) {
          nodes[node++].parent = (int)parent;
          if (--k >= 0) nodes[node++].parent = (int)parent;
          ++parent;
        }
        if ((j & 1) || j == lh[i] - 1) {
          parent0 = parent;
        } else {
          parent = parent0;
          parent0 += lw[i];
        }
      }
    }
  }
  void reset() {
    for (auto& nd : nodes) {
      nd.value = 999;
      nd.low = 0;
    }
  }
};

struct J2kPrecinct {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t cw = 0, ch = 0;
  std::vector<J2kCblk> cblks;
  J2kTagTree incl, imsb;
};
struct J2kBand {
  int bandno = 0;
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numbps = 0;
  std::vector<J2kPrecinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};
struct J2kRes {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
  J2kBand bands[3];
};
struct J2kTileComp {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numres = 0;
  std::vector<J2kRes> res;
  std::vector<int32_t> data;
};

// the packet-header bit reader (opj_bio)
struct J2kBio {
  const uint8_t* start;
  const uint8_t* end;
  const uint8_t* bp;
  uint32_t buf = 0, ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  uint32_t numbytes() const { return (uint32_t)(bp - start); }
};

bool j2k_tgt_decode(J2kBio& bio, J2kTagTree& tree, uint32_t leaf, int32_t threshold) {
  int stk[31];
  int sp = 0;
  int node = (int)leaf;
  while (tree.nodes[node].parent >= 0) {
    if (sp < 31) stk[sp++] = node;
    node = tree.nodes[node].parent;
  }
  int32_t low = 0;
  while (true) {
    J2kTagTree::Node& nd = tree.nodes[node];
    if (low > nd.low) nd.low = low;
    else low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.read(1)) nd.value = low;
      else ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return tree.nodes[node].value < threshold;
}

// --------------------------------------------------------- tier 1
// the MQ coder's states (ISO 15444-1 Table C.2)
struct J2kMqState { uint32_t qe; uint8_t nmps, nlps, sw; };
const J2kMqState kJ2kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// opj_mqc decoding over a segment followed by OpenJPEG's synthetic 0xFFFF
struct J2kMq {
  std::vector<uint8_t> buf;  // the segment and two 0xFF bytes
  size_t bp = 0;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t st[19], mps[19];
  void reset_states() {
    for (int i = 0; i < 19; ++i) {
      st[i] = 0;
      mps[i] = 0;
    }
    st[18] = 46;  // UNI
    st[17] = 3;   // AGG
    st[0] = 4;    // ZC 0
  }
  void bytein() {
    if (buf[bp] == 0xff) {
      if (buf[bp + 1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)buf[bp] << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)buf[bp] << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, size_t len) {
    buf.assign(p, p + len);
    buf.push_back(0xff);
    buf.push_back(0xff);
    bp = 0;
    c = len == 0 ? 0xffu << 16 : (uint32_t)buf[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  // opj_mqc_raw_init_dec / opj_mqc_raw_decode: BYPASS's raw bits, a 0xFF
  // byte followed by its stuffed bit's byte, up to the synthetic marker
  void raw_init(const uint8_t* p, size_t len) {
    buf.assign(p, p + len);
    buf.push_back(0xff);
    buf.push_back(0xff);
    bp = 0;
    c = 0;
    ct = 0;
  }
  int raw_decode() {
    if (ct == 0) {
      if (c == 0xff) {
        if (buf[bp] > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = buf[bp++];
          ct = 7;
        }
      } else {
        c = buf[bp++];
        ct = 8;
      }
    }
    ct--;
    return (int)((c >> ct) & 1);
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const J2kMqState& s = kJ2kMq[st[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      // LPS exchange
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        st[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        // MPS exchange
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// the zero-coding context (Table D.1) by the band (HL, band 1, swaps h
// and v)
inline int j2k_zc_ctx(int h, int v, int dg, int orient) {
  if (orient == 1) std::swap(h, v);
  if (orient != 3) {
    if (!h) {
      if (!v) return !dg ? 0 : dg == 1 ? 1 : 2;
      return v == 1 ? 3 : 4;
    }
    if (h == 1) return !v ? (!dg ? 5 : 6) : 7;
    return 8;
  }
  const int hv = h + v;
  if (!dg) return !hv ? 0 : hv == 1 ? 1 : 2;
  if (dg == 1) return !hv ? 3 : hv == 1 ? 4 : 5;
  if (dg == 2) return !hv ? 6 : 7;
  return 8;
}

// one code-block's coefficients (OpenJPEG's doubled scale), then the
// ROI shift and the halving. Each sample keeps its state (significant,
// visited in this bit-plane's significance pass, refined, and whether a
// neighbour is significant) and its neighbours' counts (significant
// horizontal, vertical and diagonal neighbours, the horizontal and
// vertical sign sums), updated as a neighbour becomes significant, on a
// grid padded by one sample all round.
struct J2kT1 {
  enum : uint8_t { kSig = 1, kVisit = 2, kRefined = 4, kNear = 8 };
  struct Near { uint8_t h, v, d; int8_t sh, sv; };
  int w = 0, h = 0, pw = 0;  // pw: the padded row
  std::vector<int32_t> data;
  std::vector<uint8_t> st;  // padded
  std::vector<Near> near;   // padded
  J2kMq mq;
  bool vsc = false;  // VSC: a stripe's last row does not see the next stripe
  bool raw = false;  // BYPASS: this pass's bits are raw
  void reset(int width, int height) {
    w = width;
    h = height;
    pw = w + 2;
    const size_t n = (size_t)pw * (h + 2);
    data.assign((size_t)w * h, 0);
    st.assign(n, 0);
    near.assign(n, Near{0, 0, 0, 0, 0});
  }
  int at(int x, int y) const { return (y + 1) * pw + x + 1; }
  void count(int j, bool hor, bool ver, int8_t s) {
    Near& nb = near[j];
    if (hor) {
      nb.h++;
      nb.sh = (int8_t)(nb.sh + s);
    } else if (ver) {
      nb.v++;
      nb.sv = (int8_t)(nb.sv + s);
    } else {
      nb.d++;
    }
    st[j] |= kNear;
  }
  // (x, y) became significant: its neighbours count it, but a stripe's
  // last row does not count the next stripe's first under VSC
  void mark(int x, int y, bool negative) {
    const int i = at(x, y);
    const int8_t s = negative ? -1 : 1;
    st[i] |= kSig;
    count(i - 1, true, false, s);
    count(i + 1, true, false, s);
    count(i + pw, false, true, s);
    count(i + pw - 1, false, false, s);
    count(i + pw + 1, false, false, s);
    if (!(vsc && ((y - 1) & 3) == 3)) {
      count(i - pw, false, true, s);
      count(i - pw - 1, false, false, s);
      count(i - pw + 1, false, false, s);
    }
  }
  void decode_sign(int x, int y, int32_t oneplushalf) {
    const Near& nb = near[at(x, y)];
    const int hc = nb.sh < -1 ? -1 : nb.sh > 1 ? 1 : nb.sh;
    const int vc = nb.sv < -1 ? -1 : nb.sv > 1 ? 1 : nb.sv;
    int ctx, xr = 0;
    if (hc == 1) {
      ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
    } else if (hc == 0) {
      ctx = vc == 0 ? 9 : 10;
      xr = vc == -1;
    } else {
      ctx = vc == 1 ? 11 : vc == 0 ? 12 : 13;
      xr = 1;
    }
    const int v = mq.decode(ctx) ^ xr;
    data[(size_t)y * w + x] = v ? -oneplushalf : oneplushalf;
    mark(x, y, v != 0);
  }
  int zc(int i, int orient) const {
    const Near& nb = near[i];
    return j2k_zc_ctx(nb.h, nb.v, nb.d, orient);
  }
  void sigpass(int bpno, int orient) {
    const int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          const int i = at(x, y);
          if ((st[i] & (kSig | kVisit | kNear)) != kNear) continue;
          if (raw) {
            if (mq.raw_decode()) {
              const bool negative = mq.raw_decode() != 0;
              data[(size_t)y * w + x] = negative ? -oph : oph;
              mark(x, y, negative);
            }
          } else if (mq.decode(zc(i, orient))) {
            decode_sign(x, y, oph);
          }
          st[i] |= kVisit;
        }
  }
  void refpass(int bpno) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          const int i = at(x, y);
          if ((st[i] & (kSig | kVisit)) != kSig) continue;
          const int ctx = (st[i] & kRefined) ? 16 : (st[i] & kNear) ? 15 : 14;
          const int v = raw ? mq.raw_decode() : mq.decode(ctx);
          int32_t& d = data[(size_t)y * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          st[i] |= kRefined;
        }
  }
  void clnpass(int bpno, int orient) {
    const int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y0 = k;
        if (k + 4 <= h) {
          const int i = at(x, k);
          if (!(st[i] | st[i + pw] | st[i + 2 * pw] | st[i + 3 * pw])) {  // run mode
            if (!mq.decode(17)) continue;
            int r = mq.decode(18);
            r = (r << 1) | mq.decode(18);
            decode_sign(x, k + r, oph);
            y0 = k + r + 1;
          }
        }
        for (int y = y0; y < k + 4 && y < h; ++y) {
          const int i = at(x, y);
          if (st[i] & (kSig | kVisit)) continue;
          if (mq.decode(zc(i, orient))) decode_sign(x, y, oph);
        }
      }
    for (uint8_t& v : st) v &= (uint8_t)~kVisit;
  }
};

// opj_t1_decode_cblk; false where OpenJPEG fails the block
bool j2k_t1_decode(J2kT1& t1, const J2kCblk& cb, const std::vector<uint8_t>& tile_data,
                   int orient, uint32_t roishift, uint32_t cblksty) {
  t1.reset(cb.x1 - cb.x0, cb.y1 - cb.y0);
  int32_t bpno = (int32_t)(roishift + cb.numbps);
  if (bpno >= 31) return false;
  int passtype = 2;
  t1.mq.reset_states();
  std::vector<uint8_t> all;
  for (const auto& ch : cb.chunks)
    all.insert(all.end(), tile_data.begin() + ch.first, tile_data.begin() + ch.first + ch.second);
  size_t at = 0;
  t1.vsc = (cblksty & 8) != 0;
  for (uint32_t s = 0; s < cb.real_num_segs; ++s) {
    const J2kSeg& seg = cb.segs[s];
    const size_t len = std::min<size_t>(seg.len, all.size() >= at ? all.size() - at : 0);
    // BYPASS: a segment of significance and refinement passes past the
    // fourth bit-plane is raw (the ROI shift counts in bpno, not numbps)
    t1.raw = (cblksty & 1) && bpno <= (int32_t)cb.numbps - 4 && passtype < 2;
    if (t1.raw) t1.mq.raw_init(all.data() + std::min(at, all.size()), len);
    else t1.mq.init(all.data() + std::min(at, all.size()), len);
    at += seg.len;
    for (uint32_t p = 0; p < seg.real_num_passes && bpno >= 1; ++p) {
      if (passtype == 0) t1.sigpass(bpno, orient);
      else if (passtype == 1) t1.refpass(bpno);
      else t1.clnpass(bpno, orient);
      if (passtype == 2 && (cblksty & 32)) {  // SEGSYM: four symbols after each cleanup
        for (int k = 0; k < 4; ++k) t1.mq.decode(18);
      }
      if ((cblksty & 2) && !t1.raw) t1.mq.reset_states();  // RESET
      if (++passtype == 3) {
        passtype = 0;
        bpno--;
      }
    }
  }
  if (roishift) {
    if (roishift >= 31) {
      std::fill(t1.data.begin(), t1.data.end(), 0);
    } else {
      const int32_t thresh = 1 << roishift;
      for (auto& v : t1.data) {
        int32_t mag = std::abs(v);
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
  for (auto& v : t1.data) v /= 2;
  return true;
}

// ------------------------------------------------------------ the DWT
// one inverse 5/3 line of sn low and dn high samples (deinterleaved:
// lows first) starting at parity cas, in place
void j2k_idwt53_line(int32_t* a, size_t stride, int32_t sn, int32_t dn, int cas,
                     std::vector<int32_t>& tmp) {
  const int32_t len = sn + dn;
  if (len <= 0) return;
  if (cas == 0 && len <= 1) return;
  if (cas == 1 && len == 1) {
    a[0] /= 2;
    return;
  }
  tmp.assign((size_t)len, 0);
  // interleave: lows at positions cas + 2i, highs at 1 - cas + 2i
  for (int32_t i = 0; i < sn; ++i) tmp[(size_t)(cas + 2 * i)] = a[(size_t)i * stride];
  for (int32_t i = 0; i < dn; ++i) tmp[(size_t)(1 - cas + 2 * i)] = a[(size_t)(sn + i) * stride];
  auto at = [&](int32_t i) {  // symmetric extension
    while (i < 0 || i >= len) {
      if (i < 0) i = -i;
      if (i >= len) i = 2 * (len - 1) - i;
    }
    return tmp[(size_t)i];
  };
  // even positions (absolute parity: index i has parity (i + cas) & 1)
  for (int32_t i = 0; i < len; ++i)
    if (((i + cas) & 1) == 0) tmp[(size_t)i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int32_t i = 0; i < len; ++i)
    if (((i + cas) & 1) == 1) tmp[(size_t)i] += (at(i - 1) + at(i + 1)) >> 1;
  for (int32_t i = 0; i < len; ++i) a[(size_t)i * stride] = tmp[(size_t)i];
}

void j2k_idwt53(J2kTileComp& tc, uint32_t numres) {
  if (numres <= 1) return;
  const J2kRes* tr = &tc.res[0];
  const int32_t w = tc.x1 - tc.x0;
  if (w == 0) return;
  int32_t rw = tr->x1 - tr->x0, rh = tr->y1 - tr->y0;
  std::vector<int32_t> tmp;
  for (uint32_t r = 1; r < numres; ++r) {
    ++tr;
    const int32_t hsn = rw, vsn = rh;
    rw = tr->x1 - tr->x0;
    rh = tr->y1 - tr->y0;
    const int hcas = tr->x0 % 2, vcas = tr->y0 % 2;
    for (int32_t j = 0; j < rh; ++j)
      j2k_idwt53_line(&tc.data[(size_t)j * w], 1, hsn, rw - hsn, hcas, tmp);
    for (int32_t j = 0; j < rw; ++j)
      j2k_idwt53_line(&tc.data[(size_t)j], (size_t)w, vsn, rh - vsn, vcas, tmp);
  }
}

// ------------------------------------------------ the packet iterator
struct J2kPi {
  int prg;
  uint32_t resno0, resno1, compno0, compno1, layno0, layno1, precno0, precno1;
};

// opj_pi_next_* over the tile as opj_pi_create_decode sets it up; calls
// f(layno, resno, compno, precno) for each packet in order, each at most
// once across the POCs (the shared include array); false where a packet
// fails
template <class P, class F>
int j2k_iterate(const J2kCodec& c, const J2kTcp& tcp, const std::vector<J2kTileComp>& tcs,
                uint32_t tx0, uint32_t ty0, uint32_t tx1, uint32_t ty1, P&& on_pi, F&& f) {
  const uint32_t nc = (uint32_t)c.comps.size();
  uint32_t max_res = 0, max_prec = 0;
  for (uint32_t k = 0; k < nc; ++k) {
    max_res = std::max(max_res, tcp.tccps[k].numres);
    for (const J2kRes& r : tcs[k].res) max_prec = std::max(max_prec, r.pw * r.ph);
  }
  const uint64_t step_p = 1, step_c = (uint64_t)max_prec * step_p, step_r = nc * step_c,
                 step_l = max_res * step_r;
  const uint64_t include_size = (uint64_t)(tcp.numlayers + 1) * step_l;
  // opj_pi_create_decode: opj_calloc(0) is NULL, so a tile whose every
  // resolution holds no precinct (components narrower than their dx)
  // fails ("Failed to decode.")
  if (include_size == 0) return -2;
  std::vector<uint8_t> include((size_t)std::min<uint64_t>(include_size, (uint64_t)1 << 30), 0);
  std::vector<J2kPi> pis;
  if (tcp.poc) {
    for (const J2kPoc& q : tcp.pocs)
      pis.push_back({q.prg, q.resno0, q.resno1, q.compno0, q.compno1, 0,
                     std::min(q.layno1, tcp.numlayers), 0, max_prec});
  } else {
    pis.push_back({tcp.prg, 0, max_res, 0, nc, 0, tcp.numlayers, 0, max_prec});
  }
  auto visit = [&](uint32_t l, uint32_t r, uint32_t k, uint32_t p) -> int {
    const uint64_t index = l * step_l + r * step_r + k * step_c + p * step_p;
    if (index >= include_size) return -1;  // "Invalid access to pi->include"
    if (include[(size_t)index]) return 0;
    include[(size_t)index] = 1;
    return f(l, r, k, p) ? 0 : -2;
  };
  for (const J2kPi& pi : pis) {
    if (pi.prg == -1) return -2;  // OPJ_PROG_UNKNOWN
    on_pi();
    if (pi.prg > 4) continue;     // opj_pi_next: no packets
    if (pi.compno0 >= nc || pi.compno1 >= nc + 1) continue;
    int rc = 0;
    if (pi.prg == 0 || pi.prg == 1) {  // LRCP, RLCP
      auto body = [&](uint32_t l, uint32_t r) -> int {
        for (uint32_t k = pi.compno0; k < pi.compno1; ++k) {
          if (r >= tcp.tccps[k].numres) continue;
          const J2kRes& res = tcs[k].res[r];
          for (uint32_t p = pi.precno0; p < res.pw * res.ph; ++p) {
            const int v = visit(l, r, k, p);
            if (v == -1) return 1;
            if (v) return v;
          }
        }
        return 0;
      };
      if (pi.prg == 0) {
        for (uint32_t l = pi.layno0; l < pi.layno1 && !rc; ++l)
          for (uint32_t r = pi.resno0; r < pi.resno1 && !rc; ++r) rc = body(l, r);
      } else {
        for (uint32_t r = pi.resno0; r < pi.resno1 && !rc; ++r)
          for (uint32_t l = pi.layno0; l < pi.layno1 && !rc; ++l) rc = body(l, r);
      }
      if (rc == 1) continue;  // the iterator's error ends this progression
      if (rc) return rc;
      continue;
    }
    // RPCL, PCRL, CPRL: positions on the reference grid
    auto steps = [&](uint32_t k, uint32_t& dx, uint32_t& dy) {
      const J2kComp& comp = c.comps[k];
      const uint32_t nr = tcp.tccps[k].numres;
      for (uint32_t r = 0; r < nr; ++r) {
        const J2kRes& res = tcs[k].res[r];
        const uint32_t ex = res.pdx + nr - 1 - r, ey = res.pdy + nr - 1 - r;
        if (ex < 32 && comp.dx <= 0xFFFFFFFFu / (1u << ex)) {
          const uint32_t v = comp.dx * (1u << ex);
          dx = !dx ? v : std::min(dx, v);
        }
        if (ey < 32 && comp.dy <= 0xFFFFFFFFu / (1u << ey)) {
          const uint32_t v = comp.dy * (1u << ey);
          dy = !dy ? v : std::min(dy, v);
        }
      }
    };
    auto packet = [&](uint32_t x, uint32_t y, uint32_t k, uint32_t r) -> int {
      const J2kComp& comp = c.comps[k];
      if (r >= tcp.tccps[k].numres) return 0;
      const J2kRes& res = tcs[k].res[r];
      const uint32_t levelno = tcp.tccps[k].numres - 1 - r;
      if ((uint32_t)(((uint64_t)comp.dx << levelno) >> levelno) != comp.dx ||
          (uint32_t)(((uint64_t)comp.dy << levelno) >> levelno) != comp.dy)
        return 0;
      const uint64_t gx = (uint64_t)comp.dx << levelno, gy = (uint64_t)comp.dy << levelno;
      const uint32_t trx0 = (uint32_t)((tx0 + gx - 1) / gx), try0 = (uint32_t)((ty0 + gy - 1) / gy);
      const uint32_t trx1 = (uint32_t)((tx1 + gx - 1) / gx), try1 = (uint32_t)((ty1 + gy - 1) / gy);
      const uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
      if (rpx >= 64 || rpy >= 64) return 0;
      if ((uint32_t)(((uint64_t)comp.dx << rpx) >> rpx) != comp.dx ||
          (uint32_t)(((uint64_t)comp.dy << rpy) >> rpy) != comp.dy)
        return 0;
      if (!((uint64_t)y % ((uint64_t)comp.dy << rpy) == 0 ||
            (y == ty0 && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
        return 0;
      if (!((uint64_t)x % ((uint64_t)comp.dx << rpx) == 0 ||
            (x == tx0 && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
        return 0;
      if (res.pw == 0 || res.ph == 0) return 0;
      if (trx0 == trx1 || try0 == try1) return 0;
      const uint32_t prci = (uint32_t)((x + gx - 1) / gx) >> res.pdx;
      const uint32_t prcj = (uint32_t)((y + gy - 1) / gy) >> res.pdy;
      const uint32_t precno = (prci - (trx0 >> res.pdx)) + (prcj - (try0 >> res.pdy)) * res.pw;
      for (uint32_t l = pi.layno0; l < pi.layno1; ++l) {
        const int v = visit(l, r, k, precno);
        if (v == -1) return 1;
        if (v) return v;
      }
      return 0;
    };
    if (pi.prg == 2 || pi.prg == 3) {  // RPCL, PCRL
      uint32_t dx = 0, dy = 0;
      for (uint32_t k = 0; k < nc; ++k) steps(k, dx, dy);
      if (dx == 0 || dy == 0) continue;
      if (pi.prg == 2) {
        for (uint32_t r = pi.resno0; r < pi.resno1 && !rc; ++r)
          for (uint32_t y = ty0; y < ty1 && !rc; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1 && !rc; x += dx - (x % dx))
              for (uint32_t k = pi.compno0; k < pi.compno1 && !rc; ++k) rc = packet(x, y, k, r);
      } else {
        for (uint32_t y = ty0; y < ty1 && !rc; y += dy - (y % dy))
          for (uint32_t x = tx0; x < tx1 && !rc; x += dx - (x % dx))
            for (uint32_t k = pi.compno0; k < pi.compno1 && !rc; ++k)
              for (uint32_t r = pi.resno0;
                   r < std::min(pi.resno1, tcp.tccps[k].numres) && !rc; ++r)
                rc = packet(x, y, k, r);
      }
    } else {  // CPRL
      for (uint32_t k = pi.compno0; k < pi.compno1 && !rc; ++k) {
        uint32_t dx = 0, dy = 0;
        steps(k, dx, dy);
        if (dx == 0 || dy == 0) {
          rc = 1;
          break;
        }
        for (uint32_t y = ty0; y < ty1 && !rc; y += dy - (y % dy))
          for (uint32_t x = tx0; x < tx1 && !rc; x += dx - (x % dx))
            for (uint32_t r = pi.resno0; r < std::min(pi.resno1, tcp.tccps[k].numres) && !rc;
                 ++r)
              rc = packet(x, y, k, r);
      }
    }
    if (rc == 1) continue;
    if (rc) return rc;
  }
  return 0;
}

// ------------------------------------------------- the tile decoder
// what the port does not decode, named: HT code-blocks, the 9/7 wavelet,
// then a Part 2 or Part 15 marker seen in a header
int j2k_refusal(const J2kCodec& c, const J2kTcp& tcp) {
  for (const J2kTccp& t : tcp.tccps) {
    if (t.cblksty & 0x40) return kJ2kHt;
    if (t.qmfbid == 0) return kJ2k97;
  }
  return c.refused;
}

bool j2k_init_seg(J2kCblk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  J2kSeg& s = cb.segs[index];
  s = J2kSeg();
  if (cblksty & 4) {  // TERMALL
    s.maxpasses = 1;
  } else if (cblksty & 1) {  // LAZY
    if (first) s.maxpasses = 10;
    else s.maxpasses = (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
  } else {
    s.maxpasses = 109;
  }
  return true;
}

uint32_t j2k_numpasses(J2kBio& bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

inline uint32_t j2k_floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

// the current tile's extent on the reference grid, clipped to the image
void j2k_tile_bounds(const J2kCodec& c, uint32_t& tx0, uint32_t& ty0, uint32_t& tx1,
                     uint32_t& ty1) {
  const uint32_t p = c.cur_tile % c.tw, q = c.cur_tile / c.tw;
  const uint32_t ltx0 = c.tx0 + p * c.tdx, lty0 = c.ty0 + q * c.tdy;
  tx0 = std::max(ltx0, c.x0);
  ty0 = std::max(lty0, c.y0);
  tx1 = std::min((uint32_t)std::min<uint64_t>((uint64_t)ltx0 + c.tdx, 0xFFFFFFFFu), c.x1);
  ty1 = std::min((uint32_t)std::min<uint64_t>((uint64_t)lty0 + c.tdy, 0xFFFFFFFFu), c.y1);
}

// decode the current tile (tx0..ty1: its bounds) into OpenJPEG's tile
// buffer layout
int j2k_decode_tile(J2kCodec& c, std::vector<uint8_t>& out, uint32_t tx0, uint32_t ty0,
                    uint32_t tx1, uint32_t ty1) {
  J2kTcp& tcp = c.tcps[c.cur_tile];
  const uint32_t nc = (uint32_t)c.comps.size();
  int rc = j2k_refusal(c, tcp);
  if (rc) return rc;
  // opj_tcd_init_tile
  std::vector<J2kTileComp> tcs(nc);
  for (uint32_t k = 0; k < nc; ++k) {
    J2kTileComp& tc = tcs[k];
    const J2kComp& comp = c.comps[k];
    const J2kTccp& tccp = tcp.tccps[k];
    tc.x0 = (int32_t)j2k_uceildiv(tx0, comp.dx);
    tc.y0 = (int32_t)j2k_uceildiv(ty0, comp.dy);
    tc.x1 = (int32_t)j2k_uceildiv(tx1, comp.dx);
    tc.y1 = (int32_t)j2k_uceildiv(ty1, comp.dy);
    tc.numres = tccp.numres;
    tc.res.assign(tccp.numres, J2kRes());
    uint32_t level = tccp.numres;
    for (uint32_t r = 0; r < tccp.numres; ++r) {
      --level;
      J2kRes& res = tc.res[r];
      res.x0 = j2k_ceildivpow2(tc.x0, (int)level);
      res.y0 = j2k_ceildivpow2(tc.y0, (int)level);
      res.x1 = j2k_ceildivpow2(tc.x1, (int)level);
      res.y1 = j2k_ceildivpow2(tc.y1, (int)level);
      const uint32_t pdx = tccp.prcw[r], pdy = tccp.prch[r];
      res.pdx = pdx;
      res.pdy = pdy;
      const int32_t tlx = j2k_floordivpow2(res.x0, (int)pdx) << pdx;
      const int32_t tly = j2k_floordivpow2(res.y0, (int)pdy) << pdy;
      const uint64_t brx = (uint64_t)(uint32_t)j2k_ceildivpow2(res.x1, (int)pdx) << pdx;
      const uint64_t bry = (uint64_t)(uint32_t)j2k_ceildivpow2(res.y1, (int)pdy) << pdy;
      if (brx > 0x7fffffff || bry > 0x7fffffff) return kCorrupt;
      res.pw = res.x0 == res.x1 ? 0 : (uint32_t)(((int64_t)brx - tlx) >> pdx);
      res.ph = res.y0 == res.y1 ? 0 : (uint32_t)(((int64_t)bry - tly) >> pdy);
      if (res.pw && (0xFFFFFFFFu / res.pw) < res.ph) return kCorrupt;
      if ((uint64_t)res.pw * res.ph > ((uint64_t)1 << 24)) return kCorrupt;
      int32_t cbgx, cbgy;
      uint32_t cbgw, cbgh;
      if (r == 0) {
        cbgx = tlx;
        cbgy = tly;
        cbgw = pdx;
        cbgh = pdy;
        res.numbands = 1;
      } else {
        cbgx = j2k_ceildivpow2(tlx, 1);
        cbgy = j2k_ceildivpow2(tly, 1);
        cbgw = pdx - 1;
        cbgh = pdy - 1;
        res.numbands = 3;
      }
      const uint32_t cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
      for (uint32_t b = 0; b < res.numbands; ++b) {
        J2kBand& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = j2k_ceildivpow2(tc.x0, (int)level);
          band.y0 = j2k_ceildivpow2(tc.y0, (int)level);
          band.x1 = j2k_ceildivpow2(tc.x1, (int)level);
          band.y1 = j2k_ceildivpow2(tc.y1, (int)level);
        } else {
          band.bandno = (int)b + 1;
          const int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
          band.x0 = j2k_ceildivpow2((int64_t)tc.x0 - (x0b << level), (int)level + 1);
          band.y0 = j2k_ceildivpow2((int64_t)tc.y0 - (y0b << level), (int)level + 1);
          band.x1 = j2k_ceildivpow2((int64_t)tc.x1 - (x0b << level), (int)level + 1);
          band.y1 = j2k_ceildivpow2((int64_t)tc.y1 - (y0b << level), (int)level + 1);
        }
        const uint32_t bi = r == 0 ? 0 : 3 * (r - 1) + 1 + b;
        band.numbps = (uint32_t)(tccp.expn[std::min<uint32_t>(bi, 96)] + (int32_t)tccp.numgbits - 1);
        const uint32_t np = res.pw * res.ph;
        band.precincts.assign(np, J2kPrecinct());
        for (uint32_t pn = 0; pn < np; ++pn) {
          J2kPrecinct& pr = band.precincts[pn];
          const int32_t sx = cbgx + (int32_t)(pn % res.pw) * (1 << cbgw);
          const int32_t sy = cbgy + (int32_t)(pn / res.pw) * (1 << cbgh);
          pr.x0 = std::max(sx, band.x0);
          pr.y0 = std::max(sy, band.y0);
          pr.x1 = std::min(sx + (1 << cbgw), band.x1);
          pr.y1 = std::min(sy + (1 << cbgh), band.y1);
          const int32_t tcx = j2k_floordivpow2(pr.x0, (int)cbw) << cbw;
          const int32_t tcy = j2k_floordivpow2(pr.y0, (int)cbh) << cbh;
          const int32_t bcx = j2k_ceildivpow2(pr.x1, (int)cbw) << cbw;
          const int32_t bcy = j2k_ceildivpow2(pr.y1, (int)cbh) << cbh;
          pr.cw = bcx > tcx ? (uint32_t)((bcx - tcx) >> cbw) : 0;
          pr.ch = bcy > tcy ? (uint32_t)((bcy - tcy) >> cbh) : 0;
          if ((uint64_t)pr.cw * pr.ch > ((uint64_t)1 << 22)) return kCorrupt;
          pr.cblks.assign((size_t)pr.cw * pr.ch, J2kCblk());
          for (uint32_t cn = 0; cn < pr.cw * pr.ch; ++cn) {
            J2kCblk& cb = pr.cblks[cn];
            const int32_t cx = tcx + (int32_t)(cn % pr.cw) * (1 << cbw);
            const int32_t cy = tcy + (int32_t)(cn / pr.cw) * (1 << cbh);
            cb.x0 = std::max(cx, pr.x0);
            cb.y0 = std::max(cy, pr.y0);
            cb.x1 = std::min(cx + (1 << cbw), pr.x1);
            cb.y1 = std::min(cy + (1 << cbh), pr.y1);
          }
          pr.incl.create(pr.cw, pr.ch);
          pr.imsb.create(pr.cw, pr.ch);
        }
      }
    }
    const uint64_t sz = (uint64_t)(tc.x1 - tc.x0) * (uint64_t)(tc.y1 - tc.y0);
    if (sz > ((uint64_t)1 << 31)) return kCorrupt;
  }
  // tier 2: opj_t2_decode_packets
  const std::vector<uint8_t>& src = tcp.data;
  size_t cur = 0;
  size_t max_len = src.size();
  std::vector<bool> first_failed;
  auto decode_packet = [&](uint32_t layno, uint32_t resno, uint32_t compno, uint32_t precno) -> bool {
    J2kRes& res = tcs[compno].res[resno];
    const J2kTccp& tccp = tcp.tccps[compno];
    if (precno >= res.pw * res.ph) return false;  // "Invalid precinct"
    // skipped: no band's precinct meets the tile (opj_tcd_is_subband_area_of_interest)
    bool skip = true;
    {
      const J2kTileComp& tc = tcs[compno];
      const uint32_t nb = resno == 0 ? tc.numres - 1 : tc.numres - resno;
      const uint32_t margin = 2;
      for (uint32_t b = 0; b < res.numbands && skip; ++b) {
        const J2kBand& band = res.bands[b];
        const J2kPrecinct& pr = band.precincts[precno];
        const uint32_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
        auto tb = [&](uint32_t v, uint32_t o) -> uint32_t {
          if (nb == 0) return v;
          const uint64_t off = ((uint64_t)1 << (nb - 1)) * o;
          if (v <= off) return 0;
          return (uint32_t)((v - off + ((uint64_t)1 << nb) - 1) >> nb);
        };
        uint32_t bx0 = tb((uint32_t)tc.x0, x0b), by0 = tb((uint32_t)tc.y0, y0b);
        uint32_t bx1 = tb((uint32_t)tc.x1, x0b), by1 = tb((uint32_t)tc.y1, y0b);
        bx0 = bx0 < margin ? 0 : bx0 - margin;
        by0 = by0 < margin ? 0 : by0 - margin;
        bx1 = (uint32_t)std::min<uint64_t>((uint64_t)bx1 + margin, 0xFFFFFFFFu);
        by1 = (uint32_t)std::min<uint64_t>((uint64_t)by1 + margin, 0xFFFFFFFFu);
        if ((uint32_t)pr.x0 < bx1 && (uint32_t)pr.y0 < by1 && (uint32_t)pr.x1 > bx0 &&
            (uint32_t)pr.y1 > by0)
          skip = false;
      }
    }
    // opj_t2_read_packet_header
    if (layno == 0) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        J2kBand& band = res.bands[b];
        if (band.empty()) continue;
        J2kPrecinct& pr = band.precincts[precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (auto& cb : pr.cblks) {
          cb.numsegs = 0;
          cb.real_num_segs = 0;
        }
      }
    }
    size_t data_at = cur;
    const size_t packet_max = max_len;
    if (tcp.csty & 2) {  // SOP: optional, skipped where present
      if (packet_max >= 6 && data_at + 1 < src.size() && src[data_at] == 0xff &&
          src[data_at + 1] == 0x91)
        data_at += 6;
    }
    const uint8_t* hdr_base;
    size_t* hdr_pos;
    size_t hdr_len;
    size_t local_pos = data_at;
    if (c.ppm) {
      hdr_base = c.ppm_data.data();
      hdr_pos = &c.ppm_pos;
      hdr_len = c.ppm_data.size() - c.ppm_pos;
    } else if (tcp.ppt) {
      hdr_base = tcp.ppt_data.data();
      hdr_pos = &tcp.ppt_pos;
      hdr_len = tcp.ppt_data.size() - tcp.ppt_pos;
    } else {
      hdr_base = src.data();
      hdr_pos = &local_pos;
      hdr_len = cur + packet_max - data_at;
    }
    J2kBio bio{hdr_base + *hdr_pos, hdr_base + *hdr_pos + hdr_len, hdr_base + *hdr_pos};
    const uint32_t present = bio.read(1);
    bool data_present = false;
    if (present) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        J2kBand& band = res.bands[b];
        if (band.empty()) continue;
        J2kPrecinct& pr = band.precincts[precno];
        for (uint32_t cn = 0; cn < pr.cw * pr.ch; ++cn) {
          J2kCblk& cb = pr.cblks[cn];
          uint32_t included;
          if (!cb.numsegs) included = j2k_tgt_decode(bio, pr.incl, cn, (int32_t)layno + 1);
          else included = bio.read(1);
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            uint32_t i = 0;
            while (!j2k_tgt_decode(bio, pr.imsb, cn, (int32_t)i)) ++i;
            cb.numbps = band.numbps + 1 - i;
            cb.numlenbits = 3;
          }
          cb.numnewpasses = j2k_numpasses(bio);
          uint32_t incr = 0;
          while (bio.read(1)) ++incr;
          cb.numlenbits += incr;
          uint32_t segno = 0;
          if (!cb.numsegs) {
            j2k_init_seg(cb, 0, tccp.cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              j2k_init_seg(cb, segno, tccp.cblksty, false);
            }
          }
          int32_t nn = (int32_t)cb.numnewpasses;
          do {
            J2kSeg& s = cb.segs[segno];
            s.numnewpasses = (uint32_t)std::min<int32_t>((int32_t)(s.maxpasses - s.numpasses), nn);
            const uint32_t bits = cb.numlenbits + j2k_floorlog2(s.numnewpasses);
            if (bits > 32) return false;  // "Invalid bit number"
            s.newlen = bits ? bio.read(bits) : 0;
            nn -= (int32_t)s.numnewpasses;
            if (nn > 0) {
              ++segno;
              j2k_init_seg(cb, segno, tccp.cblksty, false);
            }
          } while (nn > 0);
        }
      }
      data_present = true;
    }
    bio.inalign();
    size_t hlen = bio.numbytes();
    if (tcp.csty & 4) {  // EPH: required where Scod says so (a missing one fails the tile)
      const size_t at = *hdr_pos + hlen;
      if (hdr_len - hlen < 2 || hdr_base[at] != 0xff || hdr_base[at + 1] != 0x92) return false;
      hlen += 2;
    }
    *hdr_pos += hlen;
    size_t read = c.ppm || tcp.ppt ? data_at - cur : local_pos - cur;
    // opj_t2_read_packet_data
    if (data_present) {
      size_t body = cur + read;
      const size_t body_max = packet_max - read;
      size_t used = 0;
      for (uint32_t b = 0; b < res.numbands; ++b) {
        J2kBand& band = res.bands[b];
        if (band.empty()) continue;
        J2kPrecinct& pr = band.precincts[precno];
        for (auto& cb : pr.cblks) {
          if (!cb.numnewpasses) continue;
          uint32_t si;
          if (!cb.numsegs) {
            si = 0;
            ++cb.numsegs;
          } else {
            si = cb.numsegs - 1;
            if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
              ++si;
              ++cb.numsegs;
            }
          }
          do {
            J2kSeg& s = cb.segs[si];
            if ((uint64_t)used + s.newlen > body_max) return false;  // "segment too long"
            if (!skip) cb.chunks.push_back({body + used, s.newlen});
            used += s.newlen;
            s.len += s.newlen;
            s.numpasses += s.numnewpasses;
            cb.numnewpasses -= s.numnewpasses;
            if (!skip) s.real_num_passes = s.numpasses;
            if (cb.numnewpasses > 0) {
              ++si;
              ++cb.numsegs;
            }
          } while (cb.numnewpasses > 0);
          if (!skip) cb.real_num_segs = cb.numsegs;
        }
      }
      read += used;
    }
    uint32_t& decoded = c.comps[compno].resno_decoded;
    if (!skip) {
      first_failed[compno] = false;
      decoded = std::max(decoded, resno);
    }
    if (first_failed[compno] && decoded == 0) decoded = tcp.tccps[compno].numres - 1;
    cur += read;
    max_len -= read;
    return true;
  };
  // one first_pass_failed array a POC; resno_decoded is the image's, kept
  // across tiles
  {
    const int rc = j2k_iterate(
        c, tcp, tcs, tx0, ty0, tx1, ty1, [&]() { first_failed.assign(nc, true); },
        [&](uint32_t l, uint32_t r, uint32_t k, uint32_t pn) { return decode_packet(l, r, k, pn); });
    if (rc) return kCorrupt;
  }
  // tier 1 (the tile's samples allocated once its packets have read)
  for (J2kTileComp& tc : tcs)
    tc.data.assign((size_t)(tc.x1 - tc.x0) * (size_t)(tc.y1 - tc.y0), 0);
  J2kT1 t1;
  for (uint32_t k = 0; k < nc; ++k) {
    J2kTileComp& tc = tcs[k];
    const J2kTccp& tccp = tcp.tccps[k];
    const int32_t w = tc.x1 - tc.x0;
    for (uint32_t r = 0; r < tc.numres; ++r) {
      J2kRes& res = tc.res[r];
      for (uint32_t b = 0; b < res.numbands; ++b) {
        J2kBand& band = res.bands[b];
        for (J2kPrecinct& pr : band.precincts)
          for (J2kCblk& cb : pr.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            if (!j2k_t1_decode(t1, cb, src, band.bandno, tccp.roishift, tccp.cblksty))
              return kCorrupt;
            int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            for (int32_t j = 0; j < t1.h; ++j)
              for (int32_t i = 0; i < t1.w; ++i)
                tc.data[(size_t)(y + j) * w + (x + i)] = t1.data[(size_t)j * t1.w + i];
          }
      }
    }
  }
  for (uint32_t k = 0; k < nc; ++k)
    j2k_idwt53(tcs[k], std::min(c.comps[k].resno_decoded + 1, tcs[k].numres));
  // the RCT
  if (tcp.mct == 1 && nc >= 3) {
    const J2kRes& r0 = tcs[0].res[tcs[0].numres - 1];
    const size_t ns = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
    for (int k = 1; k < 3; ++k) {
      if (tcs[k].numres != tcs[0].numres) return kCorrupt;
      const J2kRes& rk = tcs[k].res[tcs[0].numres - 1];
      if ( c.comps[k].resno_decoded != c.comps[0].resno_decoded ||
          (size_t)(rk.x1 - rk.x0) * (size_t)(rk.y1 - rk.y0) != ns)
        return kCorrupt;  // "Tiles don't all have the same dimension"
    }
    int32_t *c0 = tcs[0].data.data(), *c1 = tcs[1].data.data(), *c2 = tcs[2].data.data();
    for (size_t i = 0; i < ns; ++i) {
      const int32_t y = c0[i], u = c1[i], v = c2[i];
      const int32_t g = y - ((u + v) >> 2);
      c0[i] = v + g;
      c1[i] = g;
      c2[i] = u + g;
    }
  }
  // the DC level shift and clamp, then opj_tcd_update_tile_data
  out.clear();
  for (uint32_t k = 0; k < nc; ++k) {
    J2kTileComp& tc = tcs[k];
    const J2kComp& comp = c.comps[k];
    const J2kRes& rd = tc.res[std::min(comp.resno_decoded, tc.numres - 1)];
    const int32_t w = rd.x1 - rd.x0, h = rd.y1 - rd.y0;
    const int32_t stride = (tc.x1 - tc.x0);
    int32_t lo, hi;
    if (comp.sgnd) {
      lo = -(1 << (comp.prec - 1));
      hi = (1 << (comp.prec - 1)) - 1;
    } else {
      lo = 0;
      hi = (int32_t)((1u << comp.prec) - 1);
    }
    const int32_t shift = tcp.tccps[k].dc_shift;
    uint32_t csize = (comp.prec + 7) >> 3;
    if (csize == 3) csize = 4;
    for (int32_t j = 0; j < h; ++j)
      for (int32_t i = 0; i < w; ++i) {
        int32_t v = tc.data[(size_t)j * stride + i];
        int64_t s = (int64_t)v + shift;
        v = (int32_t)(s < lo ? lo : s > hi ? hi : s);
        uint32_t u = (uint32_t)v;
        if (csize == 1) {
          out.push_back((uint8_t)u);
        } else if (csize == 2) {
          out.push_back((uint8_t)u);
          out.push_back((uint8_t)(u >> 8));
        } else {
          for (int b = 0; b < 4; ++b) out.push_back((uint8_t)(u >> (8 * b)));
        }
      }
  }
  return kOk;
}

// ------------------------------------------------- Pillow's unpackers
// ImagingConvertYCbCr2RGB's tables (ConvertYCbCr.c): each entry
// (int)(k · (i − 128) · 64 + 0.5), shifted right by 6 when used
struct J2kYcc {
  int16_t r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  J2kYcc() {
    for (int i = 0; i < 256; ++i) {
      r_cr[i] = (int16_t)(int)(1.40200 * (i - 128) * 64 + 0.5);
      g_cb[i] = (int16_t)(int)(-0.34414 * (i - 128) * 64 + 0.5);
      g_cr[i] = (int16_t)(int)(-0.71414 * (i - 128) * 64 + 0.5);
      b_cb[i] = (int16_t)(int)(1.77200 * (i - 128) * 64 + 0.5);
    }
  }
};

void j2k_ycc_to_rgb(uint8_t* px, int n) {
  static const J2kYcc t;
  for (int i = 0; i < n; ++i, px += 4) {
    const int y = px[0], cb = px[1], cr = px[2];
    const int r = y + (t.r_cr[cr] >> 6), g = y + ((t.g_cb[cb] + t.g_cr[cr]) >> 6),
              b = y + (t.b_cb[cb] >> 6);
    px[0] = (uint8_t)(r <= 0 ? 0 : r >= 255 ? 255 : r);
    px[1] = (uint8_t)(g <= 0 ? 0 : g >= 255 ? 255 : g);
    px[2] = (uint8_t)(b <= 0 ? 0 : b >= 255 ? 255 : b);
  }
}

struct J2kUnpackComp {
  int shift, offset, csiz;
  uint32_t dx, dy;
  size_t at;  // the component's start in the tile buffer
};

inline uint32_t j2k_word(const std::vector<uint8_t>& buf, size_t at, int csiz) {
  if (at + (size_t)csiz > buf.size()) return 0;
  uint32_t v = 0;
  for (int b = 0; b < csiz; ++b) v |= (uint32_t)buf[at + b] << (8 * b);
  return v;
}
inline uint32_t j2k_shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

// the unpacker j2k_decode_entry picks, applied to one tile
int j2k_unpack(const J2kCodec& c, PilMode mode, int color_space, int subsampling,
               const std::vector<uint8_t>& buf, uint32_t tx0, uint32_t ty0, uint32_t tx1,
               uint32_t ty1, PilImage& im) {
  const uint32_t nc = (uint32_t)c.comps.size();
  const uint32_t x0 = tx0 - c.x0, y0 = ty0 - c.y0, w = tx1 - tx0, h = ty1 - ty0;
  auto comp = [&](uint32_t k, int bits, bool round, size_t at) {
    J2kUnpackComp u;
    const J2kComp& cc = c.comps[k];
    u.shift = bits - (int)cc.prec;
    u.offset = cc.sgnd ? 1 << (cc.prec - 1) : 0;
    u.csiz = (int)((cc.prec + 7) >> 3);
    if (u.csiz == 3) u.csiz = 4;
    if (round && u.shift < 0) u.offset += 1 << (-u.shift - 1);
    u.dx = cc.dx;
    u.dy = cc.dy;
    u.at = at;
    return u;
  };
  // {mode, colour space, components, subsampling}
  enum { GRAY_L, GRAY_I, GRAYA_LA, GRAY_RGB, SRGB_RGB, SYCC_RGB, SRGBA_RGBA, SYCCA_RGBA, NONE };
  int which = NONE;
  const int cs = color_space;  // 1 sRGB, 2 gray, 3 sYCC, 5 CMYK
  const bool sub = subsampling != -1;
  struct Row { PilMode m; int cs; uint32_t n; bool sub; int u; };
  static const Row rows[] = {
      {kModeL, 2, 1, false, GRAY_L},      {kModeP, 1, 1, false, GRAY_L},
      {kModePA, 1, 2, false, GRAYA_LA},   {kModeI16, 2, 1, false, GRAY_I},
      {kModeLA, 2, 2, false, GRAYA_LA},   {kModeRGB, 2, 1, false, GRAY_RGB},
      {kModeRGB, 2, 2, false, GRAY_RGB},  {kModeRGB, 1, 3, true, SRGB_RGB},
      {kModeRGB, 3, 3, true, SYCC_RGB},   {kModeRGB, 1, 4, true, SRGB_RGB},
      {kModeRGB, 3, 4, true, SYCC_RGB},   {kModeRGBA, 2, 1, false, GRAY_RGB},
      {kModeRGBA, 2, 2, false, GRAYA_LA}, {kModeRGBA, 1, 3, true, SRGB_RGB},
      {kModeRGBA, 3, 3, true, SYCC_RGB},  {kModeRGBA, 1, 4, true, SRGBA_RGBA},
      {kModeRGBA, 3, 4, true, SYCCA_RGBA}, {kModeRGBA, 2, 4, true, SRGBA_RGBA},
      {kModeCMYK, 5, 4, true, SRGBA_RGBA}};
  for (const Row& r : rows)
    if (r.m == mode && r.cs == cs && r.n == nc && (r.sub || !sub)) {
      which = r.u;
      break;
    }
  if (which == NONE) return kCorrupt;
  if (which == GRAY_L || which == GRAY_I || which == GRAY_RGB) {
    const J2kUnpackComp u = comp(0, which == GRAY_I ? 16 : 8, true, 0);
    for (uint32_t y = 0; y < h; ++y)
      for (uint32_t x = 0; x < w; ++x) {
        const uint32_t word = j2k_word(buf, (size_t)u.csiz * ((size_t)y * w + x), u.csiz);
        const uint32_t v = j2k_shift((uint32_t)u.offset + word, u.shift);
        uint8_t* o = im.at((int)(x0 + x), (int)(y0 + y));
        if (which == GRAY_I) {
          o[0] = (uint8_t)v;
          o[1] = (uint8_t)(v >> 8);
        } else if (which == GRAY_L) {
          o[0] = (uint8_t)v;
        } else {
          o[0] = o[1] = o[2] = (uint8_t)v;
          o[3] = 0xff;
        }
      }
    return kOk;
  }
  if (which == GRAYA_LA) {
    const J2kUnpackComp u = comp(0, 8, true, 0);
    const J2kUnpackComp a = comp(1, 8, true, (size_t)u.csiz * w * h);
    for (uint32_t y = 0; y < h; ++y)
      for (uint32_t x = 0; x < w; ++x) {
        const size_t i = (size_t)y * w + x;
        const uint32_t v = j2k_shift((uint32_t)u.offset + j2k_word(buf, u.csiz * i, u.csiz), u.shift);
        const uint32_t av = j2k_shift((uint32_t)a.offset + j2k_word(buf, a.at + a.csiz * i, a.csiz), a.shift);
        uint8_t* o = im.at((int)(x0 + x), (int)(y0 + y));
        o[0] = o[1] = o[2] = (uint8_t)v;
        o[3] = (uint8_t)av;
      }
    return kOk;
  }
  const int nb = (which == SRGBA_RGBA || which == SYCCA_RGBA) ? 4 : 3;
  J2kUnpackComp u[4];
  size_t at = 0;
  for (int k = 0; k < nb; ++k) {
    u[k] = comp((uint32_t)k, 8, true, at);
    at += (size_t)u[k].csiz * (w / u[k].dx) * (h / u[k].dy);
  }
  std::vector<uint8_t> row((size_t)w * 4);
  for (uint32_t y = 0; y < h; ++y) {
    for (uint32_t x = 0; x < w; ++x) {
      for (int k = 0; k < nb; ++k) {
        const size_t idx = u[k].at + (size_t)u[k].csiz * ((size_t)(y / u[k].dy) * (w / u[k].dx) + x / u[k].dx);
        row[4 * x + k] = (uint8_t)j2k_shift((uint32_t)u[k].offset + j2k_word(buf, idx, u[k].csiz), u[k].shift);
      }
      if (nb == 3) row[4 * x + 3] = 0xff;
    }
    if (which == SYCC_RGB || which == SYCCA_RGBA) j2k_ycc_to_rgb(row.data(), (int)w);
    for (uint32_t x = 0; x < w; ++x) std::memcpy(im.at((int)(x0 + x), (int)(y0 + y)), &row[4 * x], 4);
  }
  return kOk;
}

// --------------------------------------------------------- the load
// JP2 boxes as opj_jp2_read_header reads them; `cs` the codestream's start
int j2k_read_jp2(J2kCodec& c, size_t& cs) {
  enum { SIG = 1, FTYP = 2, HEADER = 4, CODESTREAM = 8 };
  int st = 0;
  bool has_ihdr = false, has_jp2h = false, has_colr = false, has_pclr = false, has_cmap = false,
       has_cdef = false;
  uint32_t enumcs = 0, numcomps = 0, pclr_channels = 0;
  size_t pos = 0;
  const size_t n = c.n;
  const uint8_t* d = c.d;
  while (true) {
    if (n - pos < 8) return kCorrupt;  // opj_jp2_read_boxhdr fails: no codestream
    uint64_t length = j2k_be(d + pos, 4);
    const uint32_t type = j2k_be(d + pos + 4, 4);
    uint32_t hl = 8;
    pos += 8;
    if (length == 0) {
      const uint64_t left = n - pos;
      if (left > 0xFFFFFFFFu - 8) return kCorrupt;
      length = left + 8;
    } else if (length == 1) {
      if (n - pos < 8) return kCorrupt;
      if (j2k_be(d + pos, 4) != 0) return kCorrupt;
      length = j2k_be(d + pos + 4, 4);
      pos += 8;
      hl = 16;
    }
    if (type == 0x6a703263) {  // jp2c
      if (!(st & HEADER)) return kCorrupt;  // "bad placed jpeg codestream"
      cs = pos;
      break;
    }
    if (length < hl) return kCorrupt;  // "invalid box size"
    const uint64_t size = length - hl;
    const bool top = type == 0x6a502020 || type == 0x66747970 || type == 0x6a703268;
    const bool img = type == 0x69686472 || type == 0x636f6c72 || type == 0x62706363 ||
                     type == 0x70636c72 || type == 0x636d6170 || type == 0x63646566;
    if (!top && !img) {
      if (!(st & SIG)) return kCorrupt;
      if (!(st & FTYP)) return kCorrupt;
      if (size > n - pos) return kCorrupt;  // "Problem with skipping JPEG2000 box"
      pos += (size_t)size;
      continue;
    }
    if (!top && !(st & HEADER)) {  // a misplaced image box before jp2h: skipped
      if (size > n - pos) return kCorrupt;
      pos += (size_t)size;
      continue;
    }
    if (size > n - pos) return kCorrupt;  // "Invalid box size"
    const uint8_t* b = d + pos;
    pos += (size_t)size;
    // the image header boxes' handlers
    auto image_box = [&](uint32_t t, const uint8_t* q, uint64_t sz) -> bool {
      if (t == 0x69686472) {  // ihdr
        if (numcomps) return true;  // "Ignoring ihdr box"
        if (sz != 14) return false;
        const uint32_t hh = j2k_be(q, 4), ww = j2k_be(q + 4, 4), ncc = j2k_be(q + 8, 2);
        if (hh < 1 || ww < 1 || ncc < 1) return false;
        if (ncc - 1u >= 16384u) return false;
        numcomps = ncc;
        c.ihdr_w = ww;
        c.ihdr_h = hh;
        has_ihdr = true;
        return true;
      }
      if (t == 0x636f6c72) {  // colr
        if (sz < 3) return false;
        if (has_colr) return true;
        const int meth = q[0];
        if (meth == 1) {
          if (sz < 7) return false;
          enumcs = j2k_be(q + 3, 4);
          has_colr = true;
        } else if (meth == 2) {
          has_colr = true;
        }
        return true;
      }
      if (t == 0x62706363) return sz == numcomps;  // bpcc
      if (t == 0x70636c72) {  // pclr
        if (has_pclr || sz < 3) return false;
        const uint32_t ne = j2k_be(q, 2), npc = q[2];
        if (ne == 0 || ne > 1024 || npc == 0) return false;
        if (sz < 3 + npc) return false;
        size_t at = 3 + npc;
        for (uint32_t j = 0; j < ne; ++j)
          for (uint32_t i = 0; i < npc; ++i) {
            uint32_t k = ((q[3 + i] & 0x7f) + 1 + 7) >> 3;
            if (k > 4) k = 4;
            if (sz < at + k) return false;
            at += k;
          }
        has_pclr = true;
        pclr_channels = npc;
        return true;
      }
      if (t == 0x636d6170) {  // cmap
        if (!has_pclr || has_cmap) return false;
        if (sz < (uint64_t)pclr_channels * 4) return false;
        has_cmap = true;
        return true;
      }
      if (t == 0x63646566) {  // cdef
        if (has_cdef || sz < 2) return false;
        const uint32_t k = j2k_be(q, 2);
        if (k == 0 || sz < 2 + (uint64_t)k * 6) return false;
        has_cdef = true;
        return true;
      }
      return true;
    };
    if (type == 0x6a502020) {  // jP
      if (st != 0 || size != 4 || j2k_be(b, 4) != 0x0d0a870a) return kCorrupt;
      st |= SIG;
    } else if (type == 0x66747970) {  // ftyp
      if (st != SIG || size < 8 || ((size - 8) & 3)) return kCorrupt;
      st |= FTYP;
    } else if (type == 0x6a703268) {  // jp2h
      if ((st & FTYP) != FTYP) return kCorrupt;
      uint64_t left = size;
      const uint8_t* q = b;
      bool ihdr_here = false;
      while (left > 0) {
        if (left < 8) return kCorrupt;
        uint64_t bl = j2k_be(q, 4);
        const uint32_t bt = j2k_be(q + 4, 4);
        uint32_t bh = 8;
        if (bl == 1) {
          if (left < 16) return kCorrupt;
          if (j2k_be(q + 8, 4) != 0) return kCorrupt;
          bl = j2k_be(q + 12, 4);
          bh = 16;
          if (bl == 0) return kCorrupt;
        } else if (bl == 0) {
          return kCorrupt;
        }
        if (bl < bh) return kCorrupt;
        if (bl > left) return kCorrupt;
        if (!image_box(bt, q + bh, bl - bh)) return kCorrupt;
        if (bt == 0x69686472) ihdr_here = true;
        q += bl;
        left -= bl;
      }
      if (!ihdr_here) return kCorrupt;
      st |= HEADER;
      has_jp2h = true;
    } else {
      // an image box after jp2h: read anyway
      if (!image_box(type, b, size)) return kCorrupt;
    }
  }
  if (!has_jp2h || !has_ihdr) return kCorrupt;
  switch (enumcs) {
    case 16: c.color_space = 1; break;
    case 17: c.color_space = 2; break;
    case 18: c.color_space = 3; break;
    case 24: c.color_space = 4; break;
    case 12: c.color_space = 5; break;
    default: c.color_space = 0;  // no colr box, another method or space: unspecified
  }
  return kOk;
}

// Jpeg2KDecode.c's j2k_decode_entry into `im`
int j2k_load(const uint8_t* d, size_t n, const J2kOpen& o, PilImage& im) {
  J2kCodec c{d, n, 0};
  size_t cs = 0;
  if (o.jp2) {
    int rc = j2k_read_jp2(c, cs);
    if (rc) return rc;
  }
  c.pos = cs;
  if (!j2k_read_main_header(c)) return kCorrupt;
  if (!o.jp2) c.color_space = 0;
  const uint32_t nc = (uint32_t)c.comps.size();
  if (nc < 1 || nc > 4) return kCorrupt;
  int subsampling = -1;
  for (uint32_t k = 0; k < nc; ++k)
    if (c.comps[k].dx != 1 || c.comps[k].dy != 1) {
      subsampling = (int)k;
      break;
    }
  int cs_ = c.color_space;
  if (cs_ == 0) {
    if (nc <= 2) cs_ = 2;
    else cs_ = (subsampling == 1 || subsampling == 2) ? 3 : 1;
  }
  while (true) {
    const int t = j2k_read_tile_header(c);
    if (t < 0) return kCorrupt;
    if (t == 0) break;
    std::vector<uint8_t> buf;
    uint32_t tx0, ty0, tx1, ty1;
    // Pillow checks the tile's bounds before decoding it
    j2k_tile_bounds(c, tx0, ty0, tx1, ty1);
    if (tx0 >= tx1 || ty0 >= ty1 || (int64_t)tx1 - c.x0 > o.w || (int64_t)ty1 - c.y0 > o.h)
      return kCorrupt;
    int rc = j2k_decode_tile(c, buf, tx0, ty0, tx1, ty1);
    if (rc) return rc;
    // Pillow's buffer: at least w · h · the components' widths, zeroed
    uint64_t width = 0;
    for (const J2kComp& k : c.comps) {
      uint32_t s = (k.prec + 7) >> 3;
      width += s == 3 ? 4 : s;
    }
    const size_t need = (size_t)((uint64_t)(tx1 - tx0) * (ty1 - ty0) * width);
    if (buf.size() < need) buf.resize(need, 0);
    if (im.mode == kModeNone) im.alloc(o.mode, o.w, o.h);  // Pillow's image, at the first tile
    if ((rc = j2k_unpack(c, o.mode, cs_, subsampling, buf, tx0, ty0, tx1, ty1, im))) return rc;
    // opj_j2k_decode_tile: the tile's data freed, then the next marker
    c.tcps[c.cur_tile].data.clear();
    c.tcps[c.cur_tile].has_data = false;
    c.can_decode = false;
    c.state &= ~(uint32_t)J2kCodec::kDATA;
    if (c.left() == 0 && c.state == J2kCodec::kNEOC) continue;
    if (c.state != J2kCodec::kEOC) {
      const uint8_t* p;
      if (!c.read(2, p)) return kCorrupt;
      const uint32_t m = j2k_be(p, 2);
      if (m == 0xFFD9) {
        c.cur_tile = 0;
        c.state = J2kCodec::kEOC;
      } else if (m != 0xFF90) {
        if (c.left() == 0) {
          c.state = J2kCodec::kNEOC;
          continue;
        }
        return kCorrupt;  // "Stream too short, expected SOT"
      }
    }
  }
  if (im.mode == kModeNone) im.alloc(o.mode, o.w, o.h);  // no tile: the image as it was made
  return kOk;
}

// the palette P and PA images read through (ImagePalette's mode)
void j2k_palette(const J2kOpen& o, PilImage& im) {
  const int k = o.pal_rgba ? 4 : 3;
  im.pal_n = (int)std::min<size_t>(256, o.palette.size() / k);
  for (int i = 0; i < im.pal_n; ++i)
    for (int j = 0; j < 3; ++j) im.pal[3 * i + j] = o.palette[(size_t)k * i + j];
}

int decode_jpeg2000(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  J2kOpen o;
  int rc = j2k_pil_open(d, n, o);
  if (rc) return rc;
  w = o.w;
  h = o.h;
  PilImage im;
  if ((rc = j2k_load(d, n, o, im))) return rc;
  if (o.mode == kModeP || o.mode == kModePA) j2k_palette(o, im);
  return pil_to_gray(im, gray);
}

// the open's size; a main header whose coding style the port does not
// decode is refused by name here already
int probe_jpeg2000(const uint8_t* d, size_t n, int& w, int& h) {
  J2kOpen o;
  const int rc = j2k_pil_open(d, n, o);
  if (rc) return rc;
  w = o.w;
  h = o.h;
  J2kCodec c{d, n, 0};
  size_t cs = 0;
  if ((o.jp2 && j2k_read_jp2(c, cs)) || (c.pos = cs, !j2k_read_main_header(c))) return kOk;
  return j2k_refusal(c, c.def);
}

// ICNS's read_png_or_jpeg2000 for a JPEG 2000 entry: Jpeg2KImageFile
// over the entry (its SyntaxError raises there), then convert("RGBA") and
// convert("L"): the gray of each mode's RGB, I;16 clipped as L clips it
int decode_icns_jpeg2000(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  const int rc = decode_jpeg2000(d, n, gray, w, h);
  return rc == kPassOn ? kCorrupt : rc;
}
