// CCITT bilevel codecs in TIFF as libtiff 4.7's tif_fax3.c decodes one strip
// or tile for Pillow: Modified Huffman (2, rows byte-aligned), the same with
// rows word-aligned (32771), Group 3 (3; 1D, or 2D by T4Options bit 0;
// EOLs and fill bits) and Group 4 (4, MMR, EOFB). The decoder is libtiff's
// own state machine (tif_fax3.h's macros, kept as macros below so that the
// order of every bit read, every recovery and every run written is
// libtiff's): codes looked up LSB-first in mkg3states' tables (7-bit modes,
// 12-bit white and 13-bit black runs; an unknown code is S_Null, width 0,
// and consumes no bits), runs clipped and padded by CLEANUP_RUNS, rows
// filled by _TIFFFax3fillruns (white runs clear bits, black runs set them,
// onto whatever the row buffer held). Recovery as libtiff's:
//   - a bad code word ends its row (libtiff reports it, the decode goes on);
//   - the end of the data inside a row is an error for MH, RLEW and Group 3,
//     which fails Pillow's read, but only ends the strip for Group 4 once
//     a row was decoded ("don't error on badly-terminated strips"), and so
//     does an EOL or EOFB there: the rows after it keep what Pillow's strip
//     buffer held;
//   - past the last byte, a code reads zeros padded after the last valid
//     bit, so MH rows past the data read as EOLs (white);
//   - RLEW's word alignment drops the accumulator's bits past a multiple of
//     16 and then steps over one byte where the next byte's address is odd:
//     the address is the file's (libtiff reads the strip in place from the
//     mapped file), so it follows the strip's offset in the file.
// The output is libtiff's: 1 bits for black runs, which PIL's "1" / "1;I"
// rawmodes read by the photometric.
//
// Included by native_tiff.h before tiff_segment.

inline bool is_ccitt(int compression) {
  return compression == 2 || compression == 3 || compression == 4 || compression == 32771;
}

// tif_fax3.h's states
enum FaxState {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
  S_MakeUpB, S_MakeUp, S_EOL
};

struct FaxTabEnt {
  uint8_t state, width;
  uint32_t param;
};

// (code bits as written, most significant first; its length; its run)
struct FaxCode {
  uint16_t code;
  uint8_t len;
  uint16_t run;
};

const FaxCode kFaxWhiteTerm[64] = {
    {0x35, 8, 0},   {0x7, 6, 1},    {0x7, 4, 2},    {0x8, 4, 3},    {0xB, 4, 4},
    {0xC, 4, 5},    {0xE, 4, 6},    {0xF, 4, 7},    {0x13, 5, 8},   {0x14, 5, 9},
    {0x7, 5, 10},   {0x8, 5, 11},   {0x8, 6, 12},   {0x3, 6, 13},   {0x34, 6, 14},
    {0x35, 6, 15},  {0x2A, 6, 16},  {0x2B, 6, 17},  {0x27, 7, 18},  {0xC, 7, 19},
    {0x8, 7, 20},   {0x17, 7, 21},  {0x3, 7, 22},   {0x4, 7, 23},   {0x28, 7, 24},
    {0x2B, 7, 25},  {0x13, 7, 26},  {0x24, 7, 27},  {0x18, 7, 28},  {0x2, 8, 29},
    {0x3, 8, 30},   {0x1A, 8, 31},  {0x1B, 8, 32},  {0x12, 8, 33},  {0x13, 8, 34},
    {0x14, 8, 35},  {0x15, 8, 36},  {0x16, 8, 37},  {0x17, 8, 38},  {0x28, 8, 39},
    {0x29, 8, 40},  {0x2A, 8, 41},  {0x2B, 8, 42},  {0x2C, 8, 43},  {0x2D, 8, 44},
    {0x4, 8, 45},   {0x5, 8, 46},   {0xA, 8, 47},   {0xB, 8, 48},   {0x52, 8, 49},
    {0x53, 8, 50},  {0x54, 8, 51},  {0x55, 8, 52},  {0x24, 8, 53},  {0x25, 8, 54},
    {0x58, 8, 55},  {0x59, 8, 56},  {0x5A, 8, 57},  {0x5B, 8, 58},  {0x4A, 8, 59},
    {0x4B, 8, 60},  {0x32, 8, 61},  {0x33, 8, 62},  {0x34, 8, 63}};
const FaxCode kFaxWhiteMakeUp[27] = {
    {0x1B, 5, 64},   {0x12, 5, 128},  {0x17, 6, 192},  {0x37, 7, 256},  {0x36, 8, 320},
    {0x37, 8, 384},  {0x64, 8, 448},  {0x65, 8, 512},  {0x68, 8, 576},  {0x67, 8, 640},
    {0xCC, 9, 704},  {0xCD, 9, 768},  {0xD2, 9, 832},  {0xD3, 9, 896},  {0xD4, 9, 960},
    {0xD5, 9, 1024}, {0xD6, 9, 1088}, {0xD7, 9, 1152}, {0xD8, 9, 1216}, {0xD9, 9, 1280},
    {0xDA, 9, 1344}, {0xDB, 9, 1408}, {0x98, 9, 1472}, {0x99, 9, 1536}, {0x9A, 9, 1600},
    {0x18, 6, 1664}, {0x9B, 9, 1728}};
const FaxCode kFaxBlackTerm[64] = {
    {0x37, 10, 0},  {0x2, 3, 1},    {0x3, 2, 2},    {0x2, 2, 3},    {0x3, 3, 4},
    {0x3, 4, 5},    {0x2, 4, 6},    {0x3, 5, 7},    {0x5, 6, 8},    {0x4, 6, 9},
    {0x4, 7, 10},   {0x5, 7, 11},   {0x7, 7, 12},   {0x4, 8, 13},   {0x7, 8, 14},
    {0x18, 9, 15},  {0x17, 10, 16}, {0x18, 10, 17}, {0x8, 10, 18},  {0x67, 11, 19},
    {0x68, 11, 20}, {0x6C, 11, 21}, {0x37, 11, 22}, {0x28, 11, 23}, {0x17, 11, 24},
    {0x18, 11, 25}, {0xCA, 12, 26}, {0xCB, 12, 27}, {0xCC, 12, 28}, {0xCD, 12, 29},
    {0x68, 12, 30}, {0x69, 12, 31}, {0x6A, 12, 32}, {0x6B, 12, 33}, {0xD2, 12, 34},
    {0xD3, 12, 35}, {0xD4, 12, 36}, {0xD5, 12, 37}, {0xD6, 12, 38}, {0xD7, 12, 39},
    {0x6C, 12, 40}, {0x6D, 12, 41}, {0xDA, 12, 42}, {0xDB, 12, 43}, {0x54, 12, 44},
    {0x55, 12, 45}, {0x56, 12, 46}, {0x57, 12, 47}, {0x64, 12, 48}, {0x65, 12, 49},
    {0x52, 12, 50}, {0x53, 12, 51}, {0x24, 12, 52}, {0x37, 12, 53}, {0x38, 12, 54},
    {0x27, 12, 55}, {0x28, 12, 56}, {0x58, 12, 57}, {0x59, 12, 58}, {0x2B, 12, 59},
    {0x2C, 12, 60}, {0x5A, 12, 61}, {0x66, 12, 62}, {0x67, 12, 63}};
const FaxCode kFaxBlackMakeUp[27] = {
    {0xF, 10, 64},    {0xC8, 12, 128},  {0xC9, 12, 192},  {0x5B, 12, 256},  {0x33, 12, 320},
    {0x34, 12, 384},  {0x35, 12, 448},  {0x6C, 13, 512},  {0x6D, 13, 576},  {0x4A, 13, 640},
    {0x4B, 13, 704},  {0x4C, 13, 768},  {0x4D, 13, 832},  {0x72, 13, 896},  {0x73, 13, 960},
    {0x74, 13, 1024}, {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536}, {0x5B, 13, 1600},
    {0x64, 13, 1664}, {0x65, 13, 1728}};
// the extended make-up codes of both colours
const FaxCode kFaxMakeUp[13] = {
    {0x8, 11, 1792},  {0xC, 11, 1856},  {0xD, 11, 1920},  {0x12, 12, 1984}, {0x13, 12, 2048},
    {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1C, 12, 2368},
    {0x1D, 12, 2432}, {0x1E, 12, 2496}, {0x1F, 12, 2560}};

// mkg3states' lookup tables: the entry of every `size`-bit index whose low
// bits (the stream's first bits) start with a code
struct FaxTables {
  FaxTabEnt main[1 << 7], white[1 << 12], black[1 << 13];

  static uint32_t reversed(uint32_t code, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; ++i) r |= ((code >> (len - 1 - i)) & 1u) << i;
    return r;
  }
  static void fill(FaxTabEnt* t, int size, uint32_t code, int len, int state, uint32_t param) {
    for (uint32_t i = reversed(code, len); i < (1u << size); i += 1u << len)
      t[i] = FaxTabEnt{(uint8_t)state, (uint8_t)len, param};
  }
  template <size_t N>
  static void fill_all(FaxTabEnt* t, int size, const FaxCode (&codes)[N], int state) {
    for (const FaxCode& c : codes) fill(t, size, c.code, c.len, state, c.run);
  }
  FaxTables() {
    std::memset(main, 0, sizeof(main));
    std::memset(white, 0, sizeof(white));
    std::memset(black, 0, sizeof(black));
    fill(main, 7, 0x1, 4, S_Pass, 0);    // 0001
    fill(main, 7, 0x1, 3, S_Horiz, 0);   // 001
    fill(main, 7, 0x1, 1, S_V0, 0);      // 1
    fill(main, 7, 0x3, 3, S_VR, 1);      // 011
    fill(main, 7, 0x3, 6, S_VR, 2);      // 000011
    fill(main, 7, 0x3, 7, S_VR, 3);      // 0000011
    fill(main, 7, 0x2, 3, S_VL, 1);      // 010
    fill(main, 7, 0x2, 6, S_VL, 2);      // 000010
    fill(main, 7, 0x2, 7, S_VL, 3);      // 0000010
    fill(main, 7, 0x1, 7, S_Ext, 0);     // 0000001
    fill(main, 7, 0x0, 7, S_EOL, 0);     // 0000000
    fill_all(white, 12, kFaxWhiteMakeUp, S_MakeUpW);
    fill_all(white, 12, kFaxMakeUp, S_MakeUp);
    fill_all(white, 12, kFaxWhiteTerm, S_TermW);
    fill(white, 12, 0x0, 11, S_EOL, 0);  // an EOL: its 11 zero bits
    fill_all(black, 13, kFaxBlackMakeUp, S_MakeUpB);
    fill_all(black, 13, kFaxMakeUp, S_MakeUp);
    fill_all(black, 13, kFaxBlackTerm, S_TermB);
    fill(black, 13, 0x0, 11, S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables tables;
  return tables;
}

// T4Options (292) for Group 3, T6Options (293) for Group 4
inline uint32_t fax_options(const TiffInfo& t) {
  if (t.compression == 3) return (uint32_t)t.ifd.get(kTagT4Options, 0);
  if (t.compression == 4) return (uint32_t)t.ifd.get(kTagT6Options, 0);
  return 0;
}

// _TIFFFax3fillruns: white runs (even) clear bits, black runs (odd) set them
inline void fax_fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t fillmasks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (colour) *cp++ |= (uint8_t)(0xff >> bx);
          else *cp++ &= (uint8_t)(0xff << (8 - bx));
          run -= 8 - bx;
        }
        const uint32_t nbytes = run >> 3;
        if (nbytes) {
          std::memset(cp, colour ? 0xff : 0x00, nbytes);
          cp += nbytes;
          run &= 7;
        }
        if (run) {
          if (colour) cp[0] = (uint8_t)((cp[0] | (0xff00 >> run)) & 0xff);
          else cp[0] &= (uint8_t)(0xff >> run);
        }
      } else {
        if (colour) cp[0] |= (uint8_t)(fillmasks[run] >> bx);
        else cp[0] &= (uint8_t)~(fillmasks[run] >> bx);
      }
      x += runs[colour];
    }
  }
}

// tif_fax3.h, with libtiff's names
#define FAX_NEED_BITS8(n, eoflab)                                  \
  do {                                                             \
    if (BitsAvail < (n)) {                                         \
      if (cp >= ep) {                                              \
        if (BitsAvail == 0) goto eoflab;                           \
        BitsAvail = (n);                                           \
      } else {                                                     \
        BitAcc |= ((uint32_t)bitflip(*cp++)) << BitsAvail;         \
        BitsAvail += 8;                                            \
      }                                                            \
    }                                                              \
  } while (0)
#define FAX_NEED_BITS16(n, eoflab)                                 \
  do {                                                             \
    if (BitsAvail < (n)) {                                         \
      if (cp >= ep) {                                              \
        if (BitsAvail == 0) goto eoflab;                           \
        BitsAvail = (n);                                           \
      } else {                                                     \
        BitAcc |= ((uint32_t)bitflip(*cp++)) << BitsAvail;         \
        if ((BitsAvail += 8) < (n)) {                              \
          if (cp >= ep) {                                          \
            BitsAvail = (n);                                       \
          } else {                                                 \
            BitAcc |= ((uint32_t)bitflip(*cp++)) << BitsAvail;     \
            BitsAvail += 8;                                        \
          }                                                        \
        }                                                          \
      }                                                            \
    }                                                              \
  } while (0)
#define FAX_GET_BITS(n) (BitAcc & ((1u << (n)) - 1))
#define FAX_CLR_BITS(n) \
  do {                  \
    BitsAvail -= (n);   \
    BitAcc >>= (n);     \
  } while (0)
#define FAX_LOOKUP8(wid, tab, eoflab) \
  do {                                \
    FAX_NEED_BITS8(wid, eoflab);      \
    TabEnt = tab + FAX_GET_BITS(wid); \
    FAX_CLR_BITS(TabEnt->width);      \
  } while (0)
#define FAX_LOOKUP16(wid, tab, eoflab) \
  do {                                 \
    FAX_NEED_BITS16(wid, eoflab);      \
    TabEnt = tab + FAX_GET_BITS(wid);  \
    FAX_CLR_BITS(TabEnt->width);       \
  } while (0)
#define FAX_SETVALUE(x)                           \
  do {                                            \
    if (pa >= thisrun + nruns) return kCorrupt;   \
    *pa++ = RunLength + (x);                      \
    a0 += (x);                                    \
    RunLength = 0;                                \
  } while (0)
// libtiff 4.7's SYNC_EOL: where the zeros before an EOL's 1 run to the end
// of the data, the decoder gives up on EOLs for good (FAXMODE_NOEOL, kept
// for the image's later strips) and decodes again from the strip's first
// bit, going on at the row it was at
#define FAX_SYNC_EOL(eoflab, noeollab, retrylab)        \
  do {                                                  \
    if (!noeol) {                                       \
      if (EOLcnt == 0) {                                \
        for (;;) {                                      \
          FAX_NEED_BITS16(11, eoflab);                  \
          if (FAX_GET_BITS(11) == 0) break;             \
          FAX_CLR_BITS(1);                              \
        }                                               \
      }                                                 \
      for (;;) {                                        \
        FAX_NEED_BITS8(8, noeollab);                    \
        if (FAX_GET_BITS(8)) break;                     \
        FAX_CLR_BITS(8);                                \
      }                                                 \
      while (FAX_GET_BITS(1) == 0) FAX_CLR_BITS(1);     \
      FAX_CLR_BITS(1);                                  \
      EOLcnt = 0;                                       \
      break;                                            \
    noeollab:                                           \
      noeol = true;                                     \
      goto retrylab;                                    \
    }                                                   \
  } while (0)
#define FAX_CLEANUP_RUNS()                               \
  do {                                                   \
    if (RunLength) FAX_SETVALUE(0);                      \
    if (a0 != lastx) {                                   \
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;    \
      if (a0 < lastx) {                                  \
        if (a0 < 0) a0 = 0;                              \
        if ((pa - thisrun) & 1) FAX_SETVALUE(0);         \
        FAX_SETVALUE(lastx - a0);                        \
      } else if (a0 > lastx) {                           \
        FAX_SETVALUE(lastx);                             \
        FAX_SETVALUE(0);                                 \
      }                                                  \
    }                                                    \
  } while (0)
#define FAX_EXPAND1D(eoflab, eof1d, done1d, doneWhite1d, doneBlack1d) \
  do {                                                                \
    for (;;) {                                                        \
      for (;;) {                                                      \
        FAX_LOOKUP16(12, tab.white, eof1d);                           \
        switch (TabEnt->state) {                                      \
          case S_EOL: EOLcnt = 1; goto done1d;                        \
          case S_TermW: FAX_SETVALUE(TabEnt->param); goto doneWhite1d; \
          case S_MakeUpW: case S_MakeUp:                              \
            a0 += TabEnt->param;                                      \
            RunLength += TabEnt->param;                               \
            break;                                                    \
          default: goto done1d; /* "Bad code word" */                 \
        }                                                             \
      }                                                               \
    doneWhite1d:                                                      \
      if (a0 >= lastx) goto done1d;                                   \
      for (;;) {                                                      \
        FAX_LOOKUP16(13, tab.black, eof1d);                           \
        switch (TabEnt->state) {                                      \
          case S_EOL: EOLcnt = 1; goto done1d;                        \
          case S_TermB: FAX_SETVALUE(TabEnt->param); goto doneBlack1d; \
          case S_MakeUpB: case S_MakeUp:                              \
            a0 += TabEnt->param;                                      \
            RunLength += TabEnt->param;                               \
            break;                                                    \
          default: goto done1d;                                       \
        }                                                             \
      }                                                               \
    doneBlack1d:                                                      \
      if (a0 >= lastx) goto done1d;                                   \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;                  \
    }                                                                 \
  eof1d:                                                              \
    FAX_CLEANUP_RUNS();                                               \
    goto eoflab;                                                      \
  done1d:                                                             \
    FAX_CLEANUP_RUNS();                                               \
  } while (0)
#define FAX_CHECK_B1                                          \
  do {                                                        \
    if (pa != thisrun)                                        \
      while (b1 <= a0 && b1 < lastx) {                        \
        if (pb + 1 >= refruns + nruns) return kCorrupt;       \
        b1 += pb[0] + pb[1];                                  \
        pb += 2;                                              \
      }                                                       \
  } while (0)
#define FAX_EXPAND2D(eoflab, eof2d, eol2d, badMain2d, badBlack2d, badWhite2d, a1, a2, b1_, b2) \
  do {                                                                         \
    while (a0 < lastx) {                                                       \
      if (pa >= thisrun + nruns) return kCorrupt;                              \
      FAX_LOOKUP8(7, tab.main, eof2d);                                         \
      switch (TabEnt->state) {                                                 \
        case S_Pass:                                                           \
          FAX_CHECK_B1;                                                        \
          if (pb + 1 >= refruns + nruns) return kCorrupt;                      \
          b1 += *pb++;                                                         \
          RunLength += b1 - a0;                                                \
          a0 = b1;                                                             \
          b1 += *pb++;                                                         \
          break;                                                               \
        case S_Horiz:                                                          \
          if ((pa - thisrun) & 1) {                                            \
            for (;;) {                                                         \
              FAX_LOOKUP16(13, tab.black, eof2d);                              \
              switch (TabEnt->state) {                                         \
                case S_TermB: FAX_SETVALUE(TabEnt->param); goto a1;            \
                case S_MakeUpB: case S_MakeUp:                                 \
                  a0 += TabEnt->param;                                         \
                  RunLength += TabEnt->param;                                  \
                  break;                                                       \
                default: goto badBlack2d;                                      \
              }                                                                \
            }                                                                  \
          a1:;                                                                 \
            for (;;) {                                                         \
              FAX_LOOKUP16(12, tab.white, eof2d);                              \
              switch (TabEnt->state) {                                         \
                case S_TermW: FAX_SETVALUE(TabEnt->param); goto a2;            \
                case S_MakeUpW: case S_MakeUp:                                 \
                  a0 += TabEnt->param;                                         \
                  RunLength += TabEnt->param;                                  \
                  break;                                                       \
                default: goto badWhite2d;                                      \
              }                                                                \
            }                                                                  \
          a2:;                                                                 \
          } else {                                                             \
            for (;;) {                                                         \
              FAX_LOOKUP16(12, tab.white, eof2d);                              \
              switch (TabEnt->state) {                                         \
                case S_TermW: FAX_SETVALUE(TabEnt->param); goto b1_;           \
                case S_MakeUpW: case S_MakeUp:                                 \
                  a0 += TabEnt->param;                                         \
                  RunLength += TabEnt->param;                                  \
                  break;                                                       \
                default: goto badWhite2d;                                      \
              }                                                                \
            }                                                                  \
          b1_:;                                                                \
            for (;;) {                                                         \
              FAX_LOOKUP16(13, tab.black, eof2d);                              \
              switch (TabEnt->state) {                                         \
                case S_TermB: FAX_SETVALUE(TabEnt->param); goto b2;            \
                case S_MakeUpB: case S_MakeUp:                                 \
                  a0 += TabEnt->param;                                         \
                  RunLength += TabEnt->param;                                  \
                  break;                                                       \
                default: goto badBlack2d;                                      \
              }                                                                \
            }                                                                  \
          b2:;                                                                 \
          }                                                                    \
          FAX_CHECK_B1;                                                        \
          break;                                                               \
        case S_V0:                                                             \
          FAX_CHECK_B1;                                                        \
          FAX_SETVALUE(b1 - a0);                                               \
          if (pb >= refruns + nruns) return kCorrupt;                          \
          b1 += *pb++;                                                         \
          break;                                                               \
        case S_VR:                                                             \
          FAX_CHECK_B1;                                                        \
          FAX_SETVALUE(b1 - a0 + (int32_t)TabEnt->param);                      \
          if (pb >= refruns + nruns) return kCorrupt;                          \
          b1 += *pb++;                                                         \
          break;                                                               \
        case S_VL:                                                             \
          FAX_CHECK_B1;                                                        \
          if (b1 < (int32_t)(a0 + TabEnt->param)) goto eol2d; /* "Bad code" */ \
          FAX_SETVALUE(b1 - a0 - (int32_t)TabEnt->param);                      \
          b1 -= *--pb;                                                         \
          break;                                                               \
        case S_Ext: /* "Uncompressed data (not supported)" */                  \
          *pa++ = lastx - a0;                                                  \
          goto eol2d;                                                          \
        case S_EOL:                                                            \
          *pa++ = lastx - a0;                                                  \
          FAX_NEED_BITS8(4, eof2d);                                            \
          FAX_CLR_BITS(4);                                                     \
          EOLcnt = 1;                                                          \
          goto eol2d;                                                          \
        default:                                                               \
        badMain2d:                                                             \
          goto eol2d;                                                          \
        badBlack2d:                                                            \
          goto eol2d;                                                          \
        badWhite2d:                                                            \
          goto eol2d;                                                          \
        eof2d:                                                                 \
          FAX_CLEANUP_RUNS();                                                  \
          goto eoflab;                                                         \
      }                                                                        \
    }                                                                          \
    if (RunLength) {                                                           \
      if (RunLength + a0 < lastx) {                                            \
        FAX_NEED_BITS8(1, eof2d);                                              \
        if (!FAX_GET_BITS(1)) goto badMain2d;                                  \
        FAX_CLR_BITS(1);                                                       \
      }                                                                        \
      FAX_SETVALUE(0);                                                         \
    }                                                                          \
  eol2d:                                                                       \
    FAX_CLEANUP_RUNS();                                                        \
  } while (0)

// the codec state libtiff keeps from one strip or tile to the next of an
// image: Group 3's FAXMODE_NOEOL, and the run arrays (zeroed once by
// Fax3SetupState; Fax3PreDecode resets only the first reference run, so a
// corrupt row that reads past the reference line's runs reads what earlier
// rows, of this segment or an earlier one, left there)
struct FaxCodec {
  bool noeol = false;
  std::vector<uint32_t> runs;
};

// one strip or tile of `rows` rows of `width` pixels → out (rows ×
// ceil(width / 8) bytes); kCorrupt where libtiff's decoder returns -1.
// `out` keeps what it held where libtiff writes nothing (Group 4 rows after
// an early end); `odd_start`: the segment's first byte lies at an odd
// offset in the file (RLEW's alignment test)
int fax_decode(const uint8_t* src, size_t count, int compression, uint32_t options, int width,
               size_t rows, std::vector<uint8_t>& out, bool odd_start, FaxCodec& codec) {
  bool& noeol = codec.noeol;
  const FaxTables& tab = fax_tables();
  const int32_t lastx = width;
  const size_t rowbytes = ((size_t)width + 7) / 8;
  out.resize(rows * rowbytes);
  const bool two_d = compression == 4 || (compression == 3 && (options & 1));
  // Fax3SetupState's run arrays: nruns entries a line (doubled with a
  // reference line), curruns and refruns nruns apart
  uint32_t nruns = ((uint32_t)width + 1 + 31) / 32 * 32;
  if (two_d) nruns *= 2;
  std::vector<uint32_t>& runs = codec.runs;
  if (runs.size() != (size_t)nruns * 2) runs.assign((size_t)nruns * 2, 0);
  uint32_t* curruns = runs.data();
  uint32_t* refruns = two_d ? runs.data() + nruns : nullptr;
  if (refruns) {  // Fax3PreDecode: the reference line is white
    refruns[0] = (uint32_t)width;
    refruns[1] = 0;
  }
  const uint8_t* const start = src;
  const uint8_t* cp = src;
  const uint8_t* const ep = src + count;
  uint32_t BitAcc = 0;
  int BitsAvail = 0, EOLcnt = 0;
  int32_t a0, RunLength, b1;
  uint32_t *pa, *thisrun, *pb;
  const FaxTabEnt* TabEnt;
  uint8_t* buf = out.data();
  size_t line = 0;

  if (compression == 2 || compression == 32771) {  // Fax3DecodeRLE
    int drop;
    thisrun = curruns;
    for (; line < rows; ++line) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      FAX_EXPAND1D(rle_eof, rle_eof1d, rle_done1d, rle_white, rle_black);
      fax_fill_runs(buf, thisrun, pa, lastx);
      drop = BitsAvail & (compression == 2 ? 7 : 15);  // to a byte or word
      FAX_CLR_BITS(drop);
      if (compression == 32771) {
        const bool odd = (((size_t)(cp - start)) & 1) != (odd_start ? 1u : 0u);
        if (BitsAvail == 0 && odd) ++cp;
      }
      buf += rowbytes;
      continue;
    rle_eof:
      fax_fill_runs(buf, thisrun, pa, lastx);
      return kCorrupt;  // premature EOF: the strip's read fails
    }
    return kOk;
  }
  if (compression == 3 && !two_d) {  // Fax3Decode1D
  g31_retry:  // CACHE_STATE: the state the strip started with
    cp = start;
    BitAcc = 0;
    BitsAvail = 0;
    EOLcnt = 0;
    thisrun = curruns;
    for (; line < rows; ++line) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      FAX_SYNC_EOL(g31_eof, g31_noeol, g31_retry);
      FAX_EXPAND1D(g31_eofa, g31_eof1d, g31_done1d, g31_white, g31_black);
      fax_fill_runs(buf, thisrun, pa, lastx);
      buf += rowbytes;
      continue;
    g31_eof:
      FAX_CLEANUP_RUNS();
    g31_eofa:
      fax_fill_runs(buf, thisrun, pa, lastx);
      return kCorrupt;
    }
    return kOk;
  }
  if (compression == 3) {  // Fax3Decode2D
  g32_retry:
    cp = start;
    BitAcc = 0;
    BitsAvail = 0;
    EOLcnt = 0;
    for (; line < rows; ++line) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      FAX_SYNC_EOL(g32_eof, g32_noeol, g32_retry);
      FAX_NEED_BITS8(1, g32_eof);
      {
        const bool is1d = FAX_GET_BITS(1) != 0;
        FAX_CLR_BITS(1);
        pb = refruns;
        b1 = (int32_t)*pb++;
        if (is1d) {
          FAX_EXPAND1D(g32_eofa, g32_eof1d, g32_done1d, g32_white, g32_black);
        } else {
          FAX_EXPAND2D(g32_eofa, g32_eof2d, g32_eol2d, g32_badm, g32_badb, g32_badw, g32_h1,
                       g32_h2, g32_h3, g32_h4);
        }
      }
      fax_fill_runs(buf, thisrun, pa, lastx);
      if (pa < thisrun + nruns) FAX_SETVALUE(0);  // the imaginary change of the reference
      std::swap(curruns, refruns);
      buf += rowbytes;
      continue;
    g32_eof:
      FAX_CLEANUP_RUNS();
    g32_eofa:
      fax_fill_runs(buf, thisrun, pa, lastx);
      return kCorrupt;
    }
    return kOk;
  }
  // Fax4Decode
  for (; line < rows; ++line) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = (int32_t)*pb++;
    FAX_EXPAND2D(g4_eof, g4_eof2d, g4_eol2d, g4_badm, g4_badb, g4_badw, g4_h1, g4_h2, g4_h3,
                 g4_h4);
    if (EOLcnt) goto g4_eof;
    fax_fill_runs(buf, thisrun, pa, lastx);
    FAX_SETVALUE(0);  // the imaginary change of the reference
    std::swap(curruns, refruns);
    buf += rowbytes;
    continue;
  g4_eof:
    FAX_NEED_BITS16(13, g4_bad);
  g4_bad:
    FAX_CLR_BITS(13);
    fax_fill_runs(buf, thisrun, pa, lastx);
    // an EOFB or the end of the data ends the strip: an error only where it
    // ends the strip's first row
    return line > 0 ? kOk : kCorrupt;
  }
  return kOk;
}

#undef FAX_NEED_BITS8
#undef FAX_NEED_BITS16
#undef FAX_GET_BITS
#undef FAX_CLR_BITS
#undef FAX_LOOKUP8
#undef FAX_LOOKUP16
#undef FAX_SETVALUE
#undef FAX_SYNC_EOL
#undef FAX_CLEANUP_RUNS
#undef FAX_EXPAND1D
#undef FAX_CHECK_B1
#undef FAX_EXPAND2D
