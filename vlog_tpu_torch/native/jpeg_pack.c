/* Baseline-JPEG scan entropy packer (T.81 F.1.2): Huffman DC/AC coding of
 * interleaved, zigzagged, quantized blocks with 0xFF byte stuffing.
 *
 * Replaces the pure-Python _BitPacker hot loop in codecs/jpeg/encoder.py,
 * which profiled at ~97 s for ONE 720p thumbnail (1.45M put() calls) and
 * made sprite sheets unusable. Bit-exact against the Python path
 * (tests/test_native.py); called via ctypes so the GIL is released.
 *
 * Table layout: codes[256]/lens[256] indexed by symbol (DC: size
 * category 0..11; AC: (run<<4)|size, 0x00=EOB, 0xF0=ZRL). lens==0 marks
 * an absent symbol (never emitted by conforming block data).
 */

#include <stdint.h>
#include <stdlib.h>

typedef struct {
    uint8_t *out;
    int64_t cap;
    int64_t pos;
    uint64_t acc;
    int nbits;
    int overflow;
} jbits;

static inline void jb_put(jbits *b, uint32_t code, int len) {
    if (len <= 0) return;
    b->acc = (b->acc << len) | (uint64_t)(code & ((1u << len) - 1u));
    b->nbits += len;
    while (b->nbits >= 8) {
        b->nbits -= 8;
        uint8_t byte = (uint8_t)((b->acc >> b->nbits) & 0xFF);
        if (b->pos + 2 > b->cap) { b->overflow = 1; return; }
        b->out[b->pos++] = byte;
        if (byte == 0xFF) b->out[b->pos++] = 0x00;
    }
}

static inline void jb_flush(jbits *b) {
    if (b->nbits) {
        int pad = 8 - b->nbits;
        jb_put(b, (1u << pad) - 1u, pad);   /* pad with 1s */
    }
}

/* size category + offset code, T.81 F.1.2.1 */
static inline void jmagnitude(int32_t v, int *size, uint32_t *code) {
    if (v == 0) { *size = 0; *code = 0; return; }
    uint32_t a = (uint32_t)(v < 0 ? -v : v);
    int s = 32 - __builtin_clz(a);
    *size = s;
    *code = (uint32_t)(v > 0 ? v : v + (1 << s) - 1);
}

extern "C" int64_t vt_jpeg_pack_scan(
    const int32_t *blocks,      /* (n_blocks, 64) zigzag, MCU-interleaved */
    const uint8_t *comp,        /* per block: 0=Y, 1=Cb, 2=Cr */
    int64_t n_blocks,
    const uint16_t *dc_codes_l, const uint8_t *dc_lens_l,
    const uint16_t *ac_codes_l, const uint8_t *ac_lens_l,
    const uint16_t *dc_codes_c, const uint8_t *dc_lens_c,
    const uint16_t *ac_codes_c, const uint8_t *ac_lens_c,
    uint8_t *out, int64_t cap)
{
    jbits b = { out, cap, 0, 0, 0, 0 };
    int32_t pred[3] = { 0, 0, 0 };
    for (int64_t bi = 0; bi < n_blocks; bi++) {
        const int32_t *zz = blocks + bi * 64;
        int c = comp[bi];
        const uint16_t *dc_codes = c ? dc_codes_c : dc_codes_l;
        const uint8_t  *dc_lens  = c ? dc_lens_c  : dc_lens_l;
        const uint16_t *ac_codes = c ? ac_codes_c : ac_codes_l;
        const uint8_t  *ac_lens  = c ? ac_lens_c  : ac_lens_l;

        int size; uint32_t code;
        int32_t dc = zz[0];
        jmagnitude(dc - pred[c], &size, &code);
        pred[c] = dc;
        jb_put(&b, dc_codes[size], dc_lens[size]);
        if (size) jb_put(&b, code, size);

        int last_nz = 0;
        for (int i = 63; i >= 1; i--) {
            if (zz[i] != 0) { last_nz = i; break; }
        }
        int run = 0;
        for (int i = 1; i <= last_nz; i++) {
            int32_t v = zz[i];
            if (v == 0) { run++; continue; }
            while (run > 15) {
                jb_put(&b, ac_codes[0xF0], ac_lens[0xF0]);  /* ZRL */
                run -= 16;
            }
            jmagnitude(v, &size, &code);
            int sym = (run << 4) | size;
            jb_put(&b, ac_codes[sym], ac_lens[sym]);
            jb_put(&b, code, size);
            run = 0;
        }
        if (last_nz < 63)
            jb_put(&b, ac_codes[0x00], ac_lens[0x00]);      /* EOB */
        if (b.overflow) return -1;
    }
    jb_flush(&b);
    return b.overflow ? -1 : b.pos;
}
