/* Shared CABAC arithmetic engine (H.264 9.3.4 == H.265 9.3.4).
 *
 * Used by hevc_cabac.c and h264_cabac_enc.c; the range/transition
 * tables come from the HEVC generated header (they are the same
 * normative tables in both standards). Context-count is the max of the
 * two standards (H.264's 1024); callers initialize only their range.
 *
 * Output scheme: instead of the spec's put_bit/outstanding-bits
 * bookkeeping (a function-call chain per output bit), finished bits
 * accumulate in `low` ABOVE the 10-bit arithmetic window (`queue` of
 * them, oldest highest) and drain a byte at a time. Carries from
 * low+=range ripple into the accumulated bits natively via integer
 * addition; a carry that must ripple into bytes already drained is
 * handled the standard way: the last finalized byte is held back, and
 * a run-length of 0xFF bytes (the only values a carry can pass
 * through) flips to 0x00 when one arrives. Renormalization shifts in
 * one clz step instead of a bit loop. `queue` starts at -1: the spec's
 * discarded first output bit then occupies the same position a
 * carry-out-of-stream would (bit 8 of a drained chunk), which valid
 * arithmetic coding never sets — so no special case. The emitted
 * bitstream is IDENTICAL to the spec formulation (test_h264_cabac.py /
 * test_hevc.py assert bit-exactness against the Python reference and
 * the libavcodec oracle); only the bookkeeping differs. This is the
 * production host entropy stage's hot loop — the bit-at-a-time
 * formulation it replaces was ~4x slower.
 */
#ifndef VT_CABAC_ENGINE_H
#define VT_CABAC_ENGINE_H

#include <stdint.h>
#include <string.h>

typedef struct {
    uint32_t low, range;
    int queue;            /* finished output bits held in low above bit 9
                             (-1 until the discarded first bit exists) */
    int64_t n_ff;         /* run of 0xFF bytes awaiting carry resolution */
    int pending;          /* last finalized byte not yet written (-1: none) */
    uint8_t *out;
    int64_t cap, nbytes;
    int overflow;
    uint8_t pstate[1024], mps[1024];
} Cabac;

static void cab_start(Cabac *c, uint8_t *out, int64_t cap) {
    c->low = 0; c->range = 510;
    c->queue = -1; c->n_ff = 0; c->pending = -1;
    c->out = out; c->cap = cap; c->nbytes = 0;
    c->overflow = 0;
}

static void cab_write1(Cabac *c, uint8_t b) {
    if (c->nbytes < c->cap) c->out[c->nbytes++] = b;
    else c->overflow = 1;
}

/* Finalize one 8-bit chunk; bit 8 is a carry into already-drained
 * bytes (or, on the very first chunk, the spec-discarded first bit,
 * which is always 0 there). */
static void cab_emit8(Cabac *c, uint32_t out9) {
    uint32_t carry = out9 >> 8, data = out9 & 0xFF;
    if (carry) {
        /* ripple: held byte +1, held 0xFFs wrap to 0x00, all final */
        if (c->pending >= 0) cab_write1(c, (uint8_t)(c->pending + 1));
        for (; c->n_ff > 0; c->n_ff--) cab_write1(c, 0x00);
        c->pending = (int)data;
    } else if (data == 0xFF) {
        c->n_ff++;               /* a future carry may still flip it */
    } else {
        if (c->pending >= 0) cab_write1(c, (uint8_t)c->pending);
        for (; c->n_ff > 0; c->n_ff--) cab_write1(c, 0xFF);
        c->pending = (int)data;
    }
}

static void cab_drain(Cabac *c) {
    while (c->queue >= 8) {
        int sh = c->queue + 2;   /* top 8 output bits + carry above them */
        cab_emit8(c, c->low >> sh);
        c->low &= (1u << sh) - 1;
        c->queue -= 8;
    }
}

/* tables provided by the including .c file's generated header */
static void cab_bin(Cabac *c, int ctx, int bin) {
    int p = c->pstate[ctx];
    uint32_t rlps = HEVC_LPS[p * 4 + ((c->range >> 6) & 3)];
    c->range -= rlps;
    if (bin != c->mps[ctx]) {
        c->low += c->range; c->range = rlps;
        if (p == 0) c->mps[ctx] ^= 1;
        c->pstate[ctx] = HEVC_LPS_NEXT[p];
    } else {
        c->pstate[ctx] = HEVC_MPS_NEXT[p];
    }
    /* renorm to range >= 256 in one shift (range >= 2 always) */
    int sh = __builtin_clz(c->range) - 23;
    if (sh > 0) {
        c->range <<= sh; c->low <<= sh;
        if ((c->queue += sh) >= 8) cab_drain(c);
    }
}

static void cab_bypass(Cabac *c, int bin) {
    c->low <<= 1;
    if (bin) c->low += c->range;
    if (++c->queue >= 8) cab_drain(c);
}

/* k finished bypass bits at once: per-bit low'=2*low+b*range
 * telescopes to low<<k + v*range (range is invariant in bypass). */
static void cab_bypass_bits(Cabac *c, uint32_t v, int width) {
    while (width > 8) {
        width -= 8;
        c->low = (c->low << 8) + ((v >> width) & 0xFF) * c->range;
        c->queue += 8;
        cab_drain(c);
    }
    if (width > 0) {
        c->low = (c->low << width) + (v & ((1u << width) - 1)) * c->range;
        if ((c->queue += width) >= 8) cab_drain(c);
    }
}

static void cab_terminate(Cabac *c, int bin) {
    c->range -= 2;
    if (bin) {
        c->low += c->range; c->range = 2;
        /* renorm (shift 7), then the spec flush: the window's top two
         * bits become output, then the rbsp stop bit (literal 1) */
        c->low <<= 7; c->queue += 7;
        c->low <<= 2; c->queue += 2;
        c->low <<= 1; c->queue += 1;
        c->low = (c->low & ~0x3FFu & ~(1u << 10)) | (1u << 10);
        cab_drain(c);
    } else {
        int sh = __builtin_clz(c->range) - 23;
        if (sh > 0) {
            c->range <<= sh; c->low <<= sh;
            if ((c->queue += sh) >= 8) cab_drain(c);
        }
    }
}

static int64_t cab_finish(Cabac *c) {
    /* zero-pad to a byte boundary, drain, then flush held bytes
     * (no carries can arrive after the stop bit) */
    int pad = (8 - (c->queue & 7)) & 7;
    if (pad) { c->low <<= pad; c->queue += pad; }
    cab_drain(c);
    if (c->pending >= 0) cab_write1(c, (uint8_t)c->pending);
    for (; c->n_ff > 0; c->n_ff--) cab_write1(c, 0xFF);
    c->pending = -1;
    return c->overflow ? -1 : c->nbytes;
}

/* k-th order Exp-Golomb in bypass (suffixes of UEG0/UEG3 and HEVC
 * mvd/coeff escapes share this shape) */
static void cab_eg_bypass(Cabac *c, int value, int k) {
    while (value >= (1 << k)) { cab_bypass(c, 1); value -= 1 << k; k++; }
    cab_bypass(c, 0);
    if (k > 0) cab_bypass_bits(c, (uint32_t)value, k);
}

#endif /* VT_CABAC_ENGINE_H */
