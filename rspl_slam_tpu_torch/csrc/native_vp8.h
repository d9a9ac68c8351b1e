// Lossy WebP: VP8 key frames as libwebp 1.6.0 decodes them for PIL
// (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c and the C paths of
// dsp/dec.c, dsp/upsampling.c and dsp/yuv.h; its SIMD paths give the same
// bits), then PIL's luma:
//
//   - the frame header and the boolean decoder, with libwebp's end of data:
//     one zero byte is shifted in, and a partition read past that end fails
//     the decode at the next macroblock (or row of modes);
//   - segmentation, 1-8 token partitions, coefficient probabilities and
//     their updates, the skip probability;
//   - libwebp's dequantisation: the RFC's tables, y2 DC doubled, y2 AC
//     times 155/100 (as (x · 101581) >> 16) and at least 8, uv DC clipped at
//     index 117; coefficients stored as int16;
//   - intra prediction (16×16, the ten 4×4 modes, chroma) on unfiltered
//     samples, with libwebp's borders: 127 above the frame, 129 left of it,
//     the top-right of the rightmost macroblock replicated from above;
//   - the inverse DCT and WHT;
//   - the simple and normal loop filters in macroblock order, with
//     sharpness, per-segment levels and the first mode/ref deltas (a key
//     frame's), no filtering at all when the frame's level is 0;
//   - the fancy upsampler (each chroma sample weighted 9-3-3-1 at the
//     output pixel, the first and an even last row mirrored) and the 14-bit
//     YUV → RGB of yuv.h, over the picture cropped from its macroblocks.
//
// Included by native_runtime.cpp inside its anonymous namespace.

// RFC 6386 §14.1: dc_qlookup, ac_qlookup
const uint8_t kVp8DcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kVp8AcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// RFC 6386 §13.4: coeff_update_probs [block type][band][context][token node]
const uint8_t kVp8CoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 §13.5: default_coeff_probs
const uint8_t kVp8CoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 §11.5: kf_bmode_probs [above][left], the modes in the order of
// their leaves in the tree (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
const uint8_t kVp8BModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// --------------------------------------------------------- boolean decoder
// libwebp's VP8BitReader: range_ holds the range minus one; bytes are
// loaded one at a time (its bulk loads end at the same bit), and past the
// end one zero byte is shifted in and eof set.
struct Vp8Bool {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    range = (r << shift) - 1;
    bits -= shift;
    return bit;
  }
  uint32_t value_bits(int n) {  // VP8GetValue: MSB first
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get(0x80) << n;
    return v;
  }
  int signed_value(int n) {  // VP8GetSignedValue
    const int v = (int)value_bits(n);
    return get(0x80) ? -v : v;
  }
};

// ------------------------------------------------------------ the decoder
constexpr int kVp8Bps = 32;  // the stride of the reconstruction buffer
constexpr int kVp8YOff = kVp8Bps * 1 + 8;
constexpr int kVp8UOff = kVp8YOff + kVp8Bps * 16 + kVp8Bps;
constexpr int kVp8VOff = kVp8UOff + 16;
const uint8_t kVp8Zigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kVp8Bands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kVp8Cat3[] = {173, 148, 140, 0};
const uint8_t kVp8Cat4[] = {176, 155, 140, 135, 0};
const uint8_t kVp8Cat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kVp8Cat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kVp8Cat3456[] = {kVp8Cat3, kVp8Cat4, kVp8Cat5, kVp8Cat6};
// the 4×4 mode tree, nodes in pairs (0: B_DC_PRED, as a leaf -0)
const int8_t kVp8YModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8,
                                     -8, -9};
enum { kDcPred = 0, kTmPred = 1, kVPred = 2, kHPred = 3, kDcNoTop = 4, kDcNoLeft = 5,
       kDcNoTopLeft = 6 };

// A decoded frame: the planes at whole macroblocks, the picture's size
struct Vp8Frame {
  int w = 0, h = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;  // strides mb_w · 16 and mb_w · 8
};

// VP8GetInfo: a displayable key frame of profile ≤ 3 (else kWebpVp8Frame)
// and non-zero size whose first partition is shorter than the chunk
int vp8_info(const uint8_t* d, size_t n, size_t chunk_size, int& w, int& h) {
  if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return kCorrupt;
  const uint32_t bits = d[0] | d[1] << 8 | d[2] << 16;
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return kWebpVp8Frame;
  if ((bits >> 5) >= chunk_size) return kCorrupt;
  w = (d[7] << 8 | d[6]) & 0x3fff;
  h = (d[9] << 8 | d[8]) & 0x3fff;
  return w && h ? kOk : kCorrupt;
}

inline uint8_t vp8_clip8(int v) { return (uint8_t)(!(v & ~0xff) ? v : v < 0 ? 0 : 255); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// TransformOne: the inverse DCT of one 4×4 block added to dst
void vp8_transform(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {  // vertical pass
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += kVp8Bps) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = vp8_clip8(dst[0] + ((a + d) >> 3));
    dst[1] = vp8_clip8(dst[1] + ((b + c) >> 3));
    dst[2] = vp8_clip8(dst[2] + ((b - c) >> 3));
    dst[3] = vp8_clip8(dst[3] + ((a - d) >> 3));
  }
}

void vp8_transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
  }
}

// The full transform as libwebp's x86 build runs it (Transform_SSE2, the
// one PIL's Pillow wheel calls): the same passes in 16-bit lanes, every sum
// wrapping, the multiplies as _mm_mulhi_epi16 by 20091 and -30068. Within
// the range of coefficients an encoder writes it equals vp8_transform; past
// it (a corrupt or hand-made stream) the lanes wrap where C's ints do not.
void vp8_transform_simd(const int16_t* in, uint8_t* dst) {
  auto w = [](int v) { return (int16_t)v; };
  auto mulhi = [](int16_t a, int k) { return (int16_t)((a * k) >> 16); };
  auto cd = [&](int16_t x1, int16_t x3, int16_t& c, int16_t& d) {
    c = w(w(x1 - x3) + w(mulhi(x1, -30068) - mulhi(x3, 20091)));
    d = w(w(x1 + x3) + w(mulhi(x1, 20091) + mulhi(x3, -30068)));
  };
  int16_t t[4][4];  // t[k][i]: the vertical pass's output k of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t a = w(in[i] + in[8 + i]), b = w(in[i] - in[8 + i]);
    int16_t c, d;
    cd(in[4 + i], in[12 + i], c, d);
    t[0][i] = w(a + d);
    t[1][i] = w(b + c);
    t[2][i] = w(b - c);
    t[3][i] = w(a - d);
  }
  for (int k = 0; k < 4; ++k, dst += kVp8Bps) {  // row k
    const int16_t dc = w(t[k][0] + 4);
    const int16_t a = w(dc + t[k][2]), b = w(dc - t[k][2]);
    int16_t c, d;
    cd(t[k][1], t[k][3], c, d);
    const int16_t v[4] = {w(a + d), w(b + c), w(b - c), w(a - d)};
    for (int m = 0; m < 4; ++m) dst[m] = vp8_clip8(dst[m] + (v[m] >> 3));
  }
}

// DoTransform: the two bits of a block's coefficient count pick the
// transform: the full one (libwebp's SIMD build), or for a block of at most
// three coefficients libwebp's C TransformAC3 / TransformDC, which are the
// int transform of such blocks
inline void vp8_do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: vp8_transform_simd(src, dst); break;
    case 2: case 1: vp8_transform(src, dst); break;
    default: break;
  }
}

// ---- intra predictors over the reconstruction buffer
void vp8_true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kVp8Bps;
  for (int y = 0; y < size; ++y, dst += kVp8Bps)
    for (int x = 0; x < size; ++x) dst[x] = vp8_clip8(top[x] + dst[-1] - top[-1]);
}
void vp8_fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * kVp8Bps, v, size);
}
// 16×16 luma and 8×8 chroma: DC (and its edge variants), TM, V, H
void vp8_pred_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case kDcPred: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - kVp8Bps] + dst[-1 + j * kVp8Bps];
      vp8_fill(dst, size, dc >> (shift + 1));
      return;
    }
    case kDcNoTop: case kDcNoLeft: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j)
        dc += mode == kDcNoTop ? dst[-1 + j * kVp8Bps] : dst[j - kVp8Bps];
      vp8_fill(dst, size, dc >> shift);
      return;
    }
    case kDcNoTopLeft: vp8_fill(dst, size, 0x80); return;
    case kTmPred: vp8_true_motion(dst, size); return;
    case kVPred:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * kVp8Bps, dst - kVp8Bps, size);
      return;
    case kHPred:
      for (int j = 0; j < size; ++j) std::memset(dst + j * kVp8Bps, dst[j * kVp8Bps - 1], size);
      return;
  }
}

// the ten 4×4 modes, in libwebp's order
void vp8_pred4(uint8_t* dst, int mode) {
  const int B = kVp8Bps;
  auto at = [&](int x, int y) -> uint8_t& { return dst[x + y * B]; };
  const uint8_t* top = dst - B;
  const int X = top[-1], A = top[0], Bt = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + B], K = dst[-1 + 2 * B], L = dst[-1 + 3 * B];
  switch (mode) {
    case 0: {  // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - B] + dst[-1 + i * B];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * B, dc >> 3, 4);
      return;
    }
    case 1: vp8_true_motion(dst, 4); return;
    case 2: {  // VE
      const uint8_t v[4] = {(uint8_t)avg3(X, A, Bt), (uint8_t)avg3(A, Bt, C),
                            (uint8_t)avg3(Bt, C, D), (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * B, v, 4);
      return;
    }
    case 3: {  // HE
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + B, avg3(I, J, K), 4);
      std::memset(dst + 2 * B, avg3(J, K, L), 4);
      std::memset(dst + 3 * B, avg3(K, L, L), 4);
      return;
    }
    case 4:  // RD
      at(0, 3) = avg3(J, K, L);
      at(1, 3) = at(0, 2) = avg3(I, J, K);
      at(2, 3) = at(1, 2) = at(0, 1) = avg3(X, I, J);
      at(3, 3) = at(2, 2) = at(1, 1) = at(0, 0) = avg3(A, X, I);
      at(3, 2) = at(2, 1) = at(1, 0) = avg3(Bt, A, X);
      at(3, 1) = at(2, 0) = avg3(C, Bt, A);
      at(3, 0) = avg3(D, C, Bt);
      return;
    case 5:  // VR
      at(0, 0) = at(1, 2) = avg2(X, A);
      at(1, 0) = at(2, 2) = avg2(A, Bt);
      at(2, 0) = at(3, 2) = avg2(Bt, C);
      at(3, 0) = avg2(C, D);
      at(0, 3) = avg3(K, J, I);
      at(0, 2) = avg3(J, I, X);
      at(0, 1) = at(1, 3) = avg3(I, X, A);
      at(1, 1) = at(2, 3) = avg3(X, A, Bt);
      at(2, 1) = at(3, 3) = avg3(A, Bt, C);
      at(3, 1) = avg3(Bt, C, D);
      return;
    case 6:  // LD
      at(0, 0) = avg3(A, Bt, C);
      at(1, 0) = at(0, 1) = avg3(Bt, C, D);
      at(2, 0) = at(1, 1) = at(0, 2) = avg3(C, D, E);
      at(3, 0) = at(2, 1) = at(1, 2) = at(0, 3) = avg3(D, E, F);
      at(3, 1) = at(2, 2) = at(1, 3) = avg3(E, F, G);
      at(3, 2) = at(2, 3) = avg3(F, G, H);
      at(3, 3) = avg3(G, H, H);
      return;
    case 7:  // VL
      at(0, 0) = avg2(A, Bt);
      at(1, 0) = at(0, 2) = avg2(Bt, C);
      at(2, 0) = at(1, 2) = avg2(C, D);
      at(3, 0) = at(2, 2) = avg2(D, E);
      at(0, 1) = avg3(A, Bt, C);
      at(1, 1) = at(0, 3) = avg3(Bt, C, D);
      at(2, 1) = at(1, 3) = avg3(C, D, E);
      at(3, 1) = at(2, 3) = avg3(D, E, F);
      at(3, 2) = avg3(E, F, G);
      at(3, 3) = avg3(F, G, H);
      return;
    case 8:  // HD
      at(0, 0) = at(2, 1) = avg2(I, X);
      at(0, 1) = at(2, 2) = avg2(J, I);
      at(0, 2) = at(2, 3) = avg2(K, J);
      at(0, 3) = avg2(L, K);
      at(3, 0) = avg3(A, Bt, C);
      at(2, 0) = avg3(X, A, Bt);
      at(1, 0) = at(3, 1) = avg3(I, X, A);
      at(1, 1) = at(3, 2) = avg3(J, I, X);
      at(1, 2) = at(3, 3) = avg3(K, J, I);
      at(1, 3) = avg3(L, K, J);
      return;
    case 9:  // HU
      at(0, 0) = avg2(I, J);
      at(2, 0) = at(0, 1) = avg2(J, K);
      at(2, 1) = at(0, 2) = avg2(K, L);
      at(1, 0) = avg3(I, J, K);
      at(3, 0) = at(1, 1) = avg3(J, K, L);
      at(3, 1) = at(1, 2) = avg3(K, L, L);
      at(3, 2) = at(2, 2) = at(0, 3) = at(1, 3) = at(2, 3) = at(3, 3) = L;
      return;
  }
}

// ---- loop filters (dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline void vp8_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
}
inline void vp8_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip1(p1 + a3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a3);
}
inline void vp8_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip1(p2 + a3);
  p[-2 * step] = clip1(p1 + a2);
  p[-step] = clip1(p0 + a1);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a2);
  p[2 * step] = clip1(q2 - a3);
}
inline bool vp8_hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool vp8_needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool vp8_needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// size pixels along an edge: hstride crosses it, vstride walks it
void vp8_simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (vp8_needs_filter(p, hstride, t2)) vp8_filter2(p, hstride);
}
void vp8_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
              int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!vp8_needs_filter2(p, hstride, t2, ithresh)) continue;
    if (vp8_hev(p, hstride, hev_thresh)) vp8_filter2(p, hstride);
    else if (mb_edge) vp8_filter6(p, hstride);
    else vp8_filter4(p, hstride);
  }
}

struct Vp8FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct Vp8Decoder {
  Vp8Bool br;
  Vp8Bool parts[8];
  int num_parts_m1 = 0;
  int w = 0, h = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int segment_p[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  Vp8FInfo fstrengths[4][2];

  struct MbData {
    int16_t coeffs[384];
    bool is_i4x4 = false, skip = false;
    uint8_t imodes[16] = {0}, uvmode = 0, segment = 0;
    uint32_t nz_y = 0, nz_uv = 0;
  };
  std::vector<MbData> mb_data;
  std::vector<uint8_t> nz, nz_dc;  // [0]: the left macroblock, [1 + x]: the one above
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<Vp8FInfo> finfo;  // every macroblock's, for the filter pass

  int headers(const uint8_t* d, size_t n);
  void parse_intra_mode(int mb_x);
  int get_coeffs(Vp8Bool& tb, int type, int ctx, const int* dq, int n, int16_t* out);
  bool parse_residuals(int mb_x, Vp8Bool& tb);
  int decode(const uint8_t* d, size_t n, Vp8Frame& f);
};

int Vp8Decoder::headers(const uint8_t* d, size_t n) {
  if (n < 10) return kCorrupt;
  const uint32_t bits = d[0] | d[1] << 8 | d[2] << 16;
  const uint32_t part_len = bits >> 5;
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return kCorrupt;
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return kCorrupt;
  w = (d[7] << 8 | d[6]) & 0x3fff;
  h = (d[9] << 8 | d[8]) & 0x3fff;
  d += 10;
  n -= 10;
  mb_w = (w + 15) >> 4;
  mb_h = (h + 15) >> 4;
  if (part_len > n) return kCorrupt;  // "bad partition length"
  br.init(d, part_len);
  d += part_len;
  n -= part_len;
  br.get(0x80);  // colour space
  br.get(0x80);  // clamping type (libwebp always clamps)
  use_segment = br.get(0x80);
  if (use_segment) {
    update_map = br.get(0x80);
    if (br.get(0x80)) {  // update data
      absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) segment_p[s] = br.get(0x80) ? (int)br.value_bits(8) : 255;
  } else {
    update_map = false;
  }
  if (br.eof) return kCorrupt;  // "cannot parse segment header"
  simple = br.get(0x80);
  level = (int)br.value_bits(6);
  sharpness = (int)br.value_bits(3);
  use_lf_delta = br.get(0x80);
  if (use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) mode_lf_delta[i] = br.signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return kCorrupt;  // "cannot parse filter header"
  // the token partitions: sizes of all but the last, which takes the rest
  num_parts_m1 = (1 << br.value_bits(2)) - 1;
  const size_t last = (size_t)num_parts_m1;
  if (n < 3 * last) return kCorrupt;
  const uint8_t* sz = d;
  const uint8_t* part = d + 3 * last;
  size_t left = n - 3 * last;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
    if (psize > left) psize = left;
    parts[p].init(part, psize);
    part += psize;
    left -= psize;
  }
  parts[last].init(part, left);
  if (part >= d + n) return kCorrupt;  // the last partition is empty
  // VP8ParseQuant
  const int base_q0 = (int)br.value_bits(7);
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.get(0x80) ? br.signed_value(4) : 0;
  const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2], dquv_dc = dq[3], dquv_ac = dq[4];
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else if (i > 0) {
      dqm[i] = dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = dqm[i];
    m.y1[0] = kVp8DcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kVp8AcTable[clip(q, 127)];
    m.y2[0] = kVp8DcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kVp8AcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kVp8DcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kVp8AcTable[clip(q + dquv_ac, 127)];
  }
  br.get(0x80);  // refresh entropy probs: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = br.get(kVp8CoeffsUpdateProba[t][b][c][p])
                                  ? (uint8_t)br.value_bits(8)
                                  : kVp8CoeffsProba0[t][b][c][p];
  use_skip = br.get(0x80);
  if (use_skip) skip_p = (int)br.value_bits(8);
  // PrecomputeFilterStrengths
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) {
        base = filter_strength[s];
        if (!absolute_delta) base += level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        Vp8FInfo& info = fstrengths[s][i4x4];
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4x4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = (uint8_t)ilevel;
          info.limit = (uint8_t)(2 * lv + ilevel);
          info.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = (uint8_t)i4x4;
      }
    }
  }
  return kOk;
}

void Vp8Decoder::parse_intra_mode(int mb_x) {
  uint8_t* top = intra_t.data() + 4 * mb_x;
  uint8_t* left = intra_l;
  MbData& blk = mb_data[mb_x];
  blk.segment = !update_map ? 0
                : !br.get(segment_p[0]) ? (uint8_t)br.get(segment_p[1])
                                         : (uint8_t)(br.get(segment_p[2]) + 2);
  if (use_skip) blk.skip = br.get(skip_p);
  blk.is_i4x4 = !br.get(145);
  if (!blk.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? kTmPred : kHPred)
                                   : (br.get(163) ? kVPred : kDcPred);
    blk.imodes[0] = (uint8_t)ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = blk.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kVp8BModesProba[top[x]][ymode];
        int i = kVp8YModesIntra4[br.get(prob[0])];
        while (i > 0) i = kVp8YModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  blk.uvmode = !br.get(142) ? kDcPred : !br.get(114) ? kVPred : br.get(183) ? kTmPred : kHPred;
}

int Vp8Decoder::get_coeffs(Vp8Bool& tb, int type, int ctx, const int* dq, int n,
                           int16_t* out) {
  const uint8_t(*bands)[3][11] = proba[type];
  const uint8_t* p = bands[kVp8Bands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tb.get(p[0])) return n;
    while (!tb.get(p[1])) {
      p = bands[kVp8Bands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = bands[kVp8Bands[n + 1]];
    int v;
    if (!tb.get(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      if (!tb.get(p[3])) {
        v = !tb.get(p[4]) ? 2 : 3 + tb.get(p[5]);
      } else if (!tb.get(p[6])) {
        if (!tb.get(p[7])) {
          v = 5 + tb.get(159);
        } else {
          v = 7 + 2 * tb.get(165);
          v += tb.get(145);
        }
      } else {
        const int bit1 = tb.get(p[8]);
        const int bit0 = tb.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kVp8Cat3456[cat]; *tab; ++tab) v += v + tb.get(*tab);
        v += 3 + (8 << cat);
      }
      p = p_ctx[2];
    }
    const int s = tb.get(0x80) ? -v : v;
    out[kVp8Zigzag[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  return (nz_coeffs << 2) | (uint32_t)(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
}

// ParseResiduals: true when the macroblock has no non-zero coefficient
bool Vp8Decoder::parse_residuals(int mb_x, Vp8Bool& tb) {
  MbData& blk = mb_data[mb_x];
  const Quant& q = dqm[blk.segment];
  int16_t* dst = blk.coeffs;
  uint8_t& mb_nz = nz[1 + mb_x];
  uint8_t& left_nz = nz[0];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  std::memset(dst, 0, 384 * sizeof(int16_t));
  int first, ac_type;
  if (!blk.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = nz_dc[1 + mb_x] + nz_dc[0];
    const int n = get_coeffs(tb, 1, ctx, q.y2, 0, dc);
    nz_dc[1 + mb_x] = nz_dc[0] = n > 0;
    if (n > 1) {
      vp8_transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint8_t tnz = mb_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int n = get_coeffs(tb, ac_type, ctx, q.y1, first, dst);
      l = n > first;
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, n, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = (uint32_t)(lnz >> 4);
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(mb_nz >> (4 + ch));
    lnz = (uint8_t)(left_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int n = get_coeffs(tb, 2, ctx, q.uv, 0, dst);
        l = n > 0;
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, n, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb_nz = (uint8_t)out_t_nz;
  left_nz = (uint8_t)out_l_nz;
  blk.nz_y = non_zero_y;
  blk.nz_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

int Vp8Decoder::decode(const uint8_t* d, size_t n, Vp8Frame& f) {
  int rc = headers(d, n);
  if (rc) return rc;
  if ((uint64_t)w * h > kMaxPixels) return kCorrupt;
  f.w = w;
  f.h = h;
  f.mb_w = mb_w;
  f.mb_h = mb_h;
  const int ys = mb_w * 16, uvs = mb_w * 8;
  f.y.assign((size_t)ys * mb_h * 16, 0);
  f.u.assign((size_t)uvs * mb_h * 8, 0);
  f.v.assign((size_t)uvs * mb_h * 8, 0);
  mb_data.assign(mb_w, MbData());
  nz.assign(mb_w + 1, 0);
  nz_dc.assign(mb_w + 1, 0);
  intra_t.assign(4 * mb_w, 0);  // B_DC_PRED
  finfo.assign((size_t)mb_w * mb_h, Vp8FInfo());
  struct TopSamples {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<TopSamples> yuv_t(mb_w);
  uint8_t yuv_b[kVp8Bps * 17 + kVp8Bps * 9];
  std::memset(yuv_b, 0, sizeof(yuv_b));
  uint8_t* const y_dst = yuv_b + kVp8YOff;
  uint8_t* const u_dst = yuv_b + kVp8UOff;
  uint8_t* const v_dst = yuv_b + kVp8VOff;
  std::memset(intra_l, 0, 4);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    Vp8Bool& tb = parts[mb_y & num_parts_m1];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
    if (br.eof) return kCorrupt;  // "Premature end-of-partition0 encountered."
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MbData& blk = mb_data[mb_x];
      bool skip = use_skip ? blk.skip : false;
      if (!skip) {
        skip = parse_residuals(mb_x, tb);
      } else {
        nz[0] = nz[1 + mb_x] = 0;
        if (!blk.is_i4x4) nz_dc[0] = nz_dc[1 + mb_x] = 0;
        blk.nz_y = blk.nz_uv = 0;
      }
      if (filter_type > 0) {
        Vp8FInfo fi = fstrengths[blk.segment][blk.is_i4x4];
        fi.inner |= !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = fi;
      }
      if (tb.eof) return kCorrupt;  // "Premature end-of-file encountered."
    }
    nz[0] = nz_dc[0] = 0;  // VP8InitScanline
    std::memset(intra_l, 0, 4);
    // ReconstructRow
    for (int j = 0; j < 16; ++j) y_dst[j * kVp8Bps - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * kVp8Bps - 1] = v_dst[j * kVp8Bps - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - kVp8Bps] = u_dst[-1 - kVp8Bps] = v_dst[-1 - kVp8Bps] = 129;
    } else {
      std::memset(y_dst - kVp8Bps - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - kVp8Bps - 1, 127, 8 + 1);
      std::memset(v_dst - kVp8Bps - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MbData& blk = mb_data[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * kVp8Bps - 4, y_dst + j * kVp8Bps + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(u_dst + j * kVp8Bps - 4, u_dst + j * kVp8Bps + 4, 4);
          std::memcpy(v_dst + j * kVp8Bps - 4, v_dst + j * kVp8Bps + 4, 4);
        }
      }
      TopSamples* top = yuv_t.data() + mb_x;
      const int16_t* coeffs = blk.coeffs;
      uint32_t bits = blk.nz_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - kVp8Bps, top->y, 16);
        std::memcpy(u_dst - kVp8Bps, top->u, 8);
        std::memcpy(v_dst - kVp8Bps, top->v, 8);
      }
      if (blk.is_i4x4) {
        uint8_t* top_right = y_dst - kVp8Bps + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) std::memset(top_right, top->y[15], 4);
          else std::memcpy(top_right, top[1].y, 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * kVp8Bps, top_right, 4);
        for (int k = 0; k < 16; ++k, bits <<= 2) {
          uint8_t* dst = y_dst + (k & 3) * 4 + (k >> 2) * 4 * kVp8Bps;
          vp8_pred4(dst, blk.imodes[k]);
          vp8_do_transform(bits, coeffs + k * 16, dst);
        }
      } else {
        int mode = blk.imodes[0];
        if (mode == kDcPred)
          mode = mb_x == 0 ? (mb_y == 0 ? kDcNoTopLeft : kDcNoLeft) : (mb_y == 0 ? kDcNoTop : kDcPred);
        vp8_pred_block(y_dst, 16, mode);
        if (bits)
          for (int k = 0; k < 16; ++k, bits <<= 2)
            vp8_do_transform(bits, coeffs + k * 16, y_dst + (k & 3) * 4 + (k >> 2) * 4 * kVp8Bps);
      }
      {
        int mode = blk.uvmode;
        if (mode == kDcPred)
          mode = mb_x == 0 ? (mb_y == 0 ? kDcNoTopLeft : kDcNoLeft) : (mb_y == 0 ? kDcNoTop : kDcPred);
        vp8_pred_block(u_dst, 8, mode);
        vp8_pred_block(v_dst, 8, mode);
        for (int c = 0; c < 2; ++c) {  // DoUVTransform: TransformUV or TransformDCUV
          const uint32_t b = blk.nz_uv >> (8 * c);
          uint8_t* dst = c ? v_dst : u_dst;
          if (b & 0xff)
            for (int k = 0; k < 4; ++k)
              (b & 0xaa ? vp8_transform_simd : vp8_transform)(
                  coeffs + (16 + 4 * c + k) * 16, dst + (k & 1) * 4 + (k >> 1) * 4 * kVp8Bps);
        }
      }
      if (mb_y < mb_h - 1) {
        std::memcpy(top->y, y_dst + 15 * kVp8Bps, 16);
        std::memcpy(top->u, u_dst + 7 * kVp8Bps, 8);
        std::memcpy(top->v, v_dst + 7 * kVp8Bps, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&f.y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * kVp8Bps, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&f.u[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * kVp8Bps, 8);
        std::memcpy(&f.v[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * kVp8Bps, 8);
      }
    }
  }
  // the loop filter, macroblock by macroblock in raster order (DoFilter)
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const Vp8FInfo& fi = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        uint8_t* yp = &f.y[(size_t)mb_y * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) vp8_simple_edge(yp, 1, ys, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) vp8_simple_edge(yp + 4 * k, 1, ys, limit);
          if (mb_y > 0) vp8_simple_edge(yp, ys, 1, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) vp8_simple_edge(yp + 4 * k * ys, ys, 1, limit);
        } else {
          uint8_t* up = &f.u[(size_t)mb_y * 8 * uvs + mb_x * 8];
          uint8_t* vp = &f.v[(size_t)mb_y * 8 * uvs + mb_x * 8];
          const int il = fi.ilevel, hev = fi.hev;
          if (mb_x > 0) {
            vp8_edge(yp, 1, ys, 16, limit + 4, il, hev, true);
            vp8_edge(up, 1, uvs, 8, limit + 4, il, hev, true);
            vp8_edge(vp, 1, uvs, 8, limit + 4, il, hev, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) vp8_edge(yp + 4 * k, 1, ys, 16, limit, il, hev, false);
            vp8_edge(up + 4, 1, uvs, 8, limit, il, hev, false);
            vp8_edge(vp + 4, 1, uvs, 8, limit, il, hev, false);
          }
          if (mb_y > 0) {
            vp8_edge(yp, ys, 1, 16, limit + 4, il, hev, true);
            vp8_edge(up, uvs, 1, 8, limit + 4, il, hev, true);
            vp8_edge(vp, uvs, 1, 8, limit + 4, il, hev, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k)
              vp8_edge(yp + 4 * k * ys, ys, 1, 16, limit, il, hev, false);
            vp8_edge(up + 4 * uvs, uvs, 1, 8, limit, il, hev, false);
            vp8_edge(vp + 4 * uvs, uvs, 1, 8, limit, il, hev, false);
          }
        }
      }
    }
  }
  return kOk;
}

// ------------------------------------------------------ YUV → RGB → luma
inline int yuv_mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline uint8_t vp8_yuv_luma(int y, int u, int v) {
  const int r = yuv_clip8(yuv_mult_hi(y, 19077) + yuv_mult_hi(v, 26149) - 14234);
  const int g = yuv_clip8(yuv_mult_hi(y, 19077) - yuv_mult_hi(u, 6419) - yuv_mult_hi(v, 13320) +
                          8708);
  const int b = yuv_clip8(yuv_mult_hi(y, 19077) + yuv_mult_hi(u, 33050) - 17685);
  return pil_luma(r, g, b);
}

// UpsampleRgbaLinePair: one or two output rows from the chroma rows above
// (tu, tv) and below (cu, cv), written as luma
void vp8_upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu,
                       const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst,
                       uint8_t* bot_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
  top_dst[0] = vp8_yuv_luma(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2);
  if (bot_y)
    bot_dst[0] = vp8_yuv_luma(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    top_dst[2 * x - 1] =
        vp8_yuv_luma(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1);
    top_dst[2 * x] = vp8_yuv_luma(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1);
    if (bot_y) {
      bot_dst[2 * x - 1] =
          vp8_yuv_luma(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1);
      bot_dst[2 * x] = vp8_yuv_luma(bot_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1)) {
    top_dst[len - 1] =
        vp8_yuv_luma(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2);
    if (bot_y)
      bot_dst[len - 1] =
          vp8_yuv_luma(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2);
  }
}

// EmitFancyRGB over the whole picture: the luma of each pixel, into out
// (rows `stride` apart)
void vp8_frame_to_gray(const Vp8Frame& f, uint8_t* out, size_t stride) {
  const int ys = f.mb_w * 16, uvs = f.mb_w * 8, W = f.w, H = f.h;
  auto Y = [&](int r) { return f.y.data() + (size_t)r * ys; };
  auto U = [&](int r) { return f.u.data() + (size_t)r * uvs; };
  auto V = [&](int r) { return f.v.data() + (size_t)r * uvs; };
  vp8_upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), out, nullptr, W);
  int k = 1;
  for (; 2 * k < H; ++k)
    vp8_upsample_pair(Y(2 * k - 1), Y(2 * k), U(k - 1), V(k - 1), U(k), V(k),
                      out + (2 * k - 1) * stride, out + 2 * k * stride, W);
  if (!(H & 1))
    vp8_upsample_pair(Y(H - 1), nullptr, U(k - 1), V(k - 1), U(k - 1), V(k - 1),
                      out + (size_t)(H - 1) * stride, nullptr, W);
}
