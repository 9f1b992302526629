/* CAVLC slice entropy coder — native hot path.
 *
 * Mirrors vlog_tpu/codecs/h264/cavlc.py bit-for-bit (tests assert byte
 * equality). The reference delegated entropy coding to x264 inside the
 * ffmpeg subprocess (worker/hwaccel.py:647); in this framework the DSP
 * runs on the TPU and this file packs the quantized levels the device
 * emits — the one genuinely serial, host-bound stage of the encoder.
 *
 * Built by vlog_tpu/native/build.py (g++ -O3 -shared), loaded via
 * ctypes; vlog_tpu/codecs/h264/cavlc.py falls back to its Python path
 * when the library is unavailable.
 */

#include <stdint.h>
#include <string.h>

/* Table include is parameterized so concurrent per-process builds can
 * each use a private generated copy (see build.py). */
#ifndef VT_TABLES_INC
#define VT_TABLES_INC "cavlc_tables.inc"
#endif
#include VT_TABLES_INC

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    uint8_t *buf;
    int64_t cap;
    int64_t nbytes;     /* complete bytes written */
    uint64_t acc;       /* bit accumulator (LSB-justified) */
    int nbits;          /* bits currently in acc (< 64) */
    int overflow;
} BitWriter;

static inline void bw_flush_bytes(BitWriter *w) {
    while (w->nbits >= 8) {
        if (w->nbytes >= w->cap) { w->overflow = 1; return; }
        w->nbits -= 8;
        w->buf[w->nbytes++] = (uint8_t)((w->acc >> w->nbits) & 0xFF);
    }
}

static inline void bw_put(BitWriter *w, uint32_t bits, int n) {
    /* n <= 32. Invariant: nbits < 32 on entry (every put ends by
     * flushing when >= 32), so acc never exceeds 63 bits. */
    w->acc = (w->acc << n) | (uint64_t)(bits & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1u)));
    w->nbits += n;
    if (w->nbits >= 32) bw_flush_bytes(w);
}

static inline void bw_put_ue(BitWriter *w, uint32_t v) {
    uint32_t code = v + 1;
    int nbits = 32 - __builtin_clz(code);
    bw_put(w, 0, nbits - 1);
    bw_put(w, code, nbits);
}

static inline void bw_put_se(BitWriter *w, int32_t v) {
    bw_put_ue(w, v > 0 ? (uint32_t)(2 * v - 1) : (uint32_t)(-2 * v));
}

static inline int token_table(int nc) {
    if (nc < 2) return 0;
    if (nc < 4) return 1;
    if (nc < 8) return 2;
    return 3;
}

/* residual_block_cavlc (spec 9.2). coeffs in scan order. Returns
 * TotalCoeff. nc == -1 selects the chroma-DC tables. */
static int encode_residual(BitWriter *w, const int32_t *coeffs, int n,
                           int nc) {
    int nz_idx[16];
    int total = 0;
    for (int i = 0; i < n; i++)
        if (coeffs[i] != 0) nz_idx[total++] = i;

    int trailing = 0;
    for (int k = total - 1; k >= 0; k--) {
        int32_t c = coeffs[nz_idx[k]];
        if ((c == 1 || c == -1) && trailing < 3) trailing++;
        else break;
    }

    int idx = 4 * total + trailing;
    if (nc == -1) {
        bw_put(w, CHROMA_DC_COEFF_TOKEN_BITS[idx], CHROMA_DC_COEFF_TOKEN_LEN[idx]);
    } else {
        int tbl = token_table(nc);
        bw_put(w, COEFF_TOKEN_BITS[tbl][idx], COEFF_TOKEN_LEN[tbl][idx]);
    }
    if (total == 0) return 0;

    for (int k = total - 1; k >= total - trailing; k--)
        bw_put(w, coeffs[nz_idx[k]] < 0 ? 1u : 0u, 1);

    int suffix_len = (total > 10 && trailing < 3) ? 1 : 0;
    int first = 1;
    for (int k = total - trailing - 1; k >= 0; k--) {
        int32_t level = coeffs[nz_idx[k]];
        int32_t code = level > 0 ? 2 * level - 2 : -2 * level - 1;
        if (first && trailing < 3) code -= 2;
        first = 0;
        if (suffix_len == 0) {
            if (code < 14) {
                bw_put(w, 1, code + 1);
            } else if (code < 30) {
                bw_put(w, 1, 15);
                bw_put(w, (uint32_t)(code - 14), 4);
            } else {
                if (code - 30 >= (1 << 12)) { w->overflow = 2; return total; }
                bw_put(w, 1, 16);
                bw_put(w, (uint32_t)(code - 30), 12);
            }
        } else {
            if (code < (15 << suffix_len)) {
                bw_put(w, 1, (code >> suffix_len) + 1);
                bw_put(w, (uint32_t)(code & ((1 << suffix_len) - 1)), suffix_len);
            } else {
                bw_put(w, 1, 16);
                int32_t rem = code - (15 << suffix_len);
                if (rem >= (1 << 12)) { w->overflow = 2; return total; }
                bw_put(w, (uint32_t)rem, 12);
            }
        }
        if (suffix_len == 0) suffix_len = 1;
        int32_t mag = level < 0 ? -level : level;
        if (mag > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int total_zeros = nz_idx[total - 1] + 1 - total;
    if (total < n) {
        if (nc == -1)
            bw_put(w, CHROMA_DC_TOTAL_ZEROS_BITS[total - 1][total_zeros],
                   CHROMA_DC_TOTAL_ZEROS_LEN[total - 1][total_zeros]);
        else
            bw_put(w, TOTAL_ZEROS_BITS[total - 1][total_zeros],
                   TOTAL_ZEROS_LEN[total - 1][total_zeros]);
    }

    int zeros_left = total_zeros;
    for (int k = total - 1; k >= 1; k--) {
        if (zeros_left <= 0) break;
        int run = nz_idx[k] - nz_idx[k - 1] - 1;
        int tbl = (zeros_left < 7 ? zeros_left : 7) - 1;
        bw_put(w, RUN_BEFORE_BITS[tbl][run], RUN_BEFORE_LEN[tbl][run]);
        zeros_left -= run;
    }
    return total;
}

static inline int nc_of(int avail_a, int na, int avail_b, int nb) {
    if (avail_a && avail_b) return (na + nb + 1) >> 1;
    if (avail_a) return na;
    if (avail_b) return nb;
    return 0;
}

/* Encode slice_data for one frame of I_16x16 levels.
 *
 * Array layouts (C-contiguous int32), matching encoder.FrameLevels:
 *   luma_dc   (mbh, mbw, 4, 4)
 *   luma_ac   (mbh, mbw, 4, 4, 4, 4)   [block gy, gx, then 4x4]
 *   chroma_dc (2, mbh, mbw, 2, 2)
 *   chroma_ac (2, mbh, mbw, 2, 2, 4, 4)
 *
 * header_bytes/header_bits: the already-encoded slice header — copied
 * in front, with its trailing partial bits continued seamlessly.
 * nz_scratch: caller-provided int32 scratch of size
 *   mbh*4*mbw*4 + 2*mbh*2*mbw*2  (zeroed by this function).
 *
 * Returns total bytes written (header + slice_data + rbsp trailing,
 * byte-aligned), or -1 on overflow / error.
 */
int64_t vt_cavlc_encode_slice(
    const int32_t *luma_dc, const int32_t *luma_ac,
    const int32_t *chroma_dc, const int32_t *chroma_ac,
    int mbh, int mbw,
    const uint8_t *header_bytes, int64_t n_header_bytes,
    uint32_t header_tail_bits, int n_header_tail_bits,
    int32_t *nz_scratch,
    uint8_t *out, int64_t out_cap)
{
    BitWriter w = {out, out_cap, 0, 0, 0, 0};
    if (n_header_bytes > out_cap) return -1;
    memcpy(out, header_bytes, (size_t)n_header_bytes);
    w.nbytes = n_header_bytes;
    if (n_header_tail_bits > 0)
        bw_put(&w, header_tail_bits, n_header_tail_bits);

    const int gw = mbw * 4;             /* luma nz grid width  */
    const int cw = mbw * 2;             /* chroma nz grid width */
    int32_t *nz_luma = nz_scratch;                    /* (mbh*4, gw) */
    int32_t *nz_chroma = nz_scratch + (int64_t)mbh * 4 * gw; /* (2, mbh*2, cw) */
    memset(nz_scratch, 0,
           sizeof(int32_t) * ((int64_t)mbh * 4 * gw + 2 * (int64_t)mbh * 2 * cw));

    int32_t scan[16];

    for (int my = 0; my < mbh; my++) {
        for (int mx = 0; mx < mbw; mx++) {
            const int32_t *dc = luma_dc + (((int64_t)my * mbw + mx) << 4);
            const int32_t *ac = luma_ac + (((int64_t)my * mbw + mx) << 8);
            const int32_t *cdc[2], *cac[2];
            for (int comp = 0; comp < 2; comp++) {
                cdc[comp] = chroma_dc
                    + ((((int64_t)comp * mbh + my) * mbw + mx) << 2);
                cac[comp] = chroma_ac
                    + ((((int64_t)comp * mbh + my) * mbw + mx) << 6);
            }

            int cbp_luma = 0;
            for (int i = 0; i < 256 && !cbp_luma; i++)
                if (ac[i]) cbp_luma = 15;
            int any_cac = 0, any_cdc = 0;
            for (int comp = 0; comp < 2 && !any_cac; comp++)
                for (int i = 0; i < 64 && !any_cac; i++)
                    if (cac[comp][i]) any_cac = 1;
            for (int comp = 0; comp < 2 && !any_cdc; comp++)
                for (int i = 0; i < 4 && !any_cdc; i++)
                    if (cdc[comp][i]) any_cdc = 1;
            int cbp_chroma = any_cac ? 2 : (any_cdc ? 1 : 0);

            int luma_mode = my == 0 ? 2 : 0;     /* DC : Vertical */
            int chroma_mode = my == 0 ? 0 : 2;
            int mb_type = 1 + luma_mode + 4 * cbp_chroma
                        + 12 * (cbp_luma ? 1 : 0);
            bw_put_ue(&w, (uint32_t)mb_type);
            bw_put_ue(&w, (uint32_t)chroma_mode);
            bw_put_se(&w, 0);                    /* mb_qp_delta */

            int gy = my * 4, gx = mx * 4;
            int nc = nc_of(gx > 0, gx > 0 ? nz_luma[gy * gw + gx - 1] : 0,
                           gy > 0, gy > 0 ? nz_luma[(gy - 1) * gw + gx] : 0);
            for (int i = 0; i < 16; i++) scan[i] = dc[ZIGZAG16[i]];
            encode_residual(&w, scan, 16, nc);

            if (cbp_luma) {
                for (int bi = 0; bi < 16; bi++) {
                    int blk = LUMA_ORDER[bi];
                    int by = blk >> 2, bx = blk & 3;
                    int y = gy + by, x = gx + bx;
                    const int32_t *b = ac + ((by * 4 + bx) << 4);
                    nc = nc_of(x > 0, x > 0 ? nz_luma[y * gw + x - 1] : 0,
                               y > 0, y > 0 ? nz_luma[(y - 1) * gw + x] : 0);
                    for (int i = 1; i < 16; i++) scan[i - 1] = b[ZIGZAG16[i]];
                    int tc = encode_residual(&w, scan, 15, nc);
                    nz_luma[y * gw + x] = tc;
                }
            }

            if (cbp_chroma > 0) {
                for (int comp = 0; comp < 2; comp++)
                    encode_residual(&w, cdc[comp], 4, -1);  /* raster 2x2 */
            }

            if (cbp_chroma == 2) {
                int cy = my * 2, cx = mx * 2;
                for (int comp = 0; comp < 2; comp++) {
                    int32_t *grid = nz_chroma + (int64_t)comp * mbh * 2 * cw;
                    for (int by = 0; by < 2; by++) {
                        for (int bx = 0; bx < 2; bx++) {
                            int y = cy + by, x = cx + bx;
                            const int32_t *b = cac[comp] + ((by * 2 + bx) << 4);
                            nc = nc_of(x > 0, x > 0 ? grid[y * cw + x - 1] : 0,
                                       y > 0, y > 0 ? grid[(y - 1) * cw + x] : 0);
                            for (int i = 1; i < 16; i++)
                                scan[i - 1] = b[ZIGZAG16[i]];
                            int tc = encode_residual(&w, scan, 15, nc);
                            grid[y * cw + x] = tc;
                        }
                    }
                }
            }
            if (w.overflow) return -1;
        }
    }

    /* rbsp trailing: stop bit + align */
    bw_put(&w, 1, 1);
    if (w.nbits & 7) bw_put(&w, 0, 8 - (w.nbits & 7));
    bw_flush_bytes(&w);
    if (w.overflow || w.nbits != 0) return -1;
    return w.nbytes;
}

/* ---------------------------------------------------------------------
 * P slices (P_L0_16x16 / P_Skip) — mirrors cavlc.PSliceEncoder bit-for-
 * bit (tests/test_native.py asserts byte equality). P frames are the
 * bulk of every chain (GOP_LEN-1 of GOP_LEN frames), so this is the
 * steady-state host entropy path.
 * ------------------------------------------------------------------- */

/* Table 9-4 "Inter" column: coded_block_pattern -> codeNum. */
static const uint8_t CBP_INTER_CODE[48] = {
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12,
};

static inline int32_t median3(int32_t a, int32_t b, int32_t c) {
    if (a > b) { int32_t t = a; a = b; b = t; }
    if (b > c) { b = c; }
    return a > b ? a : b;
}

/* Median MV predictor (8.4.1.3.1) over the quarter-pel mv grid.
 * mvs: (mbh, mbw, 2) as (x, y). */
static void mv_pred(const int32_t *mvs, int mbh, int mbw, int my, int mx,
                    int32_t *px, int32_t *py) {
    int a_ok = mx > 0;
    int b_ok = my > 0;
    int c_ok = b_ok && mx < mbw - 1;
    int d_ok = b_ok && mx > 0;
    int32_t ax = 0, ay = 0, bx = 0, by = 0, cx = 0, cy = 0;
    int c_av = 0;
    if (a_ok) {
        ax = mvs[((int64_t)my * mbw + mx - 1) * 2];
        ay = mvs[((int64_t)my * mbw + mx - 1) * 2 + 1];
    }
    if (b_ok) {
        bx = mvs[(((int64_t)my - 1) * mbw + mx) * 2];
        by = mvs[(((int64_t)my - 1) * mbw + mx) * 2 + 1];
    }
    if (c_ok) {
        c_av = 1;
        cx = mvs[(((int64_t)my - 1) * mbw + mx + 1) * 2];
        cy = mvs[(((int64_t)my - 1) * mbw + mx + 1) * 2 + 1];
    } else if (d_ok) {
        c_av = 1;
        cx = mvs[(((int64_t)my - 1) * mbw + mx - 1) * 2];
        cy = mvs[(((int64_t)my - 1) * mbw + mx - 1) * 2 + 1];
    }
    int n_avail = a_ok + b_ok + c_av;
    if (n_avail == 1) {
        if (a_ok) { *px = ax; *py = ay; }
        else if (b_ok) { *px = bx; *py = by; }
        else { *px = cx; *py = cy; }
        return;
    }
    *px = median3(ax, bx, cx);
    *py = median3(ay, by, cy);
}

/* P_Skip inferred MV (8.4.1.1). */
static void skip_mv(const int32_t *mvs, int mbh, int mbw, int my, int mx,
                    int32_t *px, int32_t *py) {
    int a_ok = mx > 0;
    int b_ok = my > 0;
    if (!a_ok || !b_ok) { *px = 0; *py = 0; return; }
    const int32_t *a = mvs + ((int64_t)my * mbw + mx - 1) * 2;
    const int32_t *b = mvs + (((int64_t)my - 1) * mbw + mx) * 2;
    if ((a[0] == 0 && a[1] == 0) || (b[0] == 0 && b[1] == 0)) {
        *px = 0; *py = 0; return;
    }
    mv_pred(mvs, mbh, mbw, my, mx, px, py);
}

/* i8x8/i4x4 coding-order offsets (quadrant zigzag). */
static const int BLK2[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};

/* Encode one P frame's slice_data.
 *
 * Layouts (C-contiguous int32):
 *   luma      (mbh, mbw, 4, 4, 4, 4)   [block by, bx, then 4x4]
 *   chroma_dc (2, mbh, mbw, 2, 2)
 *   chroma_ac (2, mbh, mbw, 2, 2, 4, 4)
 *   mv        (mbh, mbw, 2)            QUARTER pels, (y, x) — DSP order
 * scratch: int32 of size mbh*4*mbw*4 + 2*mbh*2*mbw*2 + mbh*mbw*2.
 * Returns bytes written or -1 on overflow.
 */
int64_t vt_cavlc_encode_p_slice(
    const int32_t *luma, const int32_t *chroma_dc, const int32_t *chroma_ac,
    const int32_t *mv,
    int mbh, int mbw,
    const uint8_t *header_bytes, int64_t n_header_bytes,
    uint32_t header_tail_bits, int n_header_tail_bits,
    int32_t *scratch,
    uint8_t *out, int64_t out_cap)
{
    BitWriter w = {out, out_cap, 0, 0, 0, 0};
    if (n_header_bytes > out_cap) return -1;
    memcpy(out, header_bytes, (size_t)n_header_bytes);
    w.nbytes = n_header_bytes;
    if (n_header_tail_bits > 0)
        bw_put(&w, header_tail_bits, n_header_tail_bits);

    const int gw = mbw * 4;
    const int cw = mbw * 2;
    int32_t *nz_luma = scratch;
    int32_t *nz_chroma = scratch + (int64_t)mbh * 4 * gw;
    int32_t *mvs = nz_chroma + 2 * (int64_t)mbh * 2 * cw;  /* quarter, (x,y) */
    memset(scratch, 0, sizeof(int32_t) *
           ((int64_t)mbh * 4 * gw + 2 * (int64_t)mbh * 2 * cw
            + (int64_t)mbh * mbw * 2));

    int32_t scan[16];
    uint32_t skip_run = 0;

    for (int my = 0; my < mbh; my++) {
        for (int mx = 0; mx < mbw; mx++) {
            const int64_t mb = (int64_t)my * mbw + mx;
            const int32_t *lu = luma + (mb << 8);
            const int32_t *cdc[2], *cac[2];
            for (int comp = 0; comp < 2; comp++) {
                cdc[comp] = chroma_dc + ((((int64_t)comp * mbh + my) * mbw + mx) << 2);
                cac[comp] = chroma_ac + ((((int64_t)comp * mbh + my) * mbw + mx) << 6);
            }
            /* bitstream (x, y) from DSP (y, x), both quarter-pel */
            int32_t mvx = mv[mb * 2 + 1];
            int32_t mvy = mv[mb * 2];

            /* CBP: luma bit per 8x8 quadrant + chroma 0/1/2 */
            int cbp = 0;
            for (int i8 = 0; i8 < 4; i8++) {
                int oy = BLK2[i8][0], ox = BLK2[i8][1];
                int any = 0;
                for (int s = 0; s < 4 && !any; s++) {
                    int by = 2 * oy + BLK2[s][0], bx = 2 * ox + BLK2[s][1];
                    const int32_t *b = lu + ((by * 4 + bx) << 4);
                    for (int i = 0; i < 16; i++)
                        if (b[i]) { any = 1; break; }
                }
                if (any) cbp |= 1 << i8;
            }
            int any_cac = 0, any_cdc = 0;
            for (int comp = 0; comp < 2 && !any_cac; comp++)
                for (int i = 0; i < 64; i++)
                    if (cac[comp][i]) { any_cac = 1; break; }
            for (int comp = 0; comp < 2 && !any_cdc; comp++)
                for (int i = 0; i < 4; i++)
                    if (cdc[comp][i]) { any_cdc = 1; break; }
            cbp |= (any_cac ? 2 : (any_cdc ? 1 : 0)) << 4;

            int32_t smx, smy;
            skip_mv(mvs, mbh, mbw, my, mx, &smx, &smy);
            if (cbp == 0 && mvx == smx && mvy == smy) {
                mvs[mb * 2] = smx;
                mvs[mb * 2 + 1] = smy;
                skip_run++;
                continue;
            }
            bw_put_ue(&w, skip_run);
            skip_run = 0;
            int32_t pmx, pmy;
            mv_pred(mvs, mbh, mbw, my, mx, &pmx, &pmy);
            mvs[mb * 2] = mvx;
            mvs[mb * 2 + 1] = mvy;
            bw_put_ue(&w, 0);                    /* mb_type P_L0_16x16 */
            bw_put_se(&w, mvx - pmx);
            bw_put_se(&w, mvy - pmy);
            bw_put_ue(&w, CBP_INTER_CODE[cbp]);
            if (cbp) {
                bw_put_se(&w, 0);                /* mb_qp_delta */
                int gy = my * 4, gx = mx * 4;
                for (int i8 = 0; i8 < 4; i8++) {
                    int oy = BLK2[i8][0], ox = BLK2[i8][1];
                    for (int s = 0; s < 4; s++) {
                        int by = 2 * oy + BLK2[s][0], bx = 2 * ox + BLK2[s][1];
                        int y = gy + by, x = gx + bx;
                        if (!((cbp >> i8) & 1)) {
                            nz_luma[y * gw + x] = 0;
                            continue;
                        }
                        const int32_t *b = lu + ((by * 4 + bx) << 4);
                        int nc = nc_of(x > 0, x > 0 ? nz_luma[y * gw + x - 1] : 0,
                                       y > 0, y > 0 ? nz_luma[(y - 1) * gw + x] : 0);
                        for (int i = 0; i < 16; i++) scan[i] = b[ZIGZAG16[i]];
                        int tc = encode_residual(&w, scan, 16, nc);
                        nz_luma[y * gw + x] = tc;
                    }
                }
                int cbp_chroma = cbp >> 4;
                if (cbp_chroma > 0) {
                    for (int comp = 0; comp < 2; comp++)
                        encode_residual(&w, cdc[comp], 4, -1);
                }
                int cy = my * 2, cx = mx * 2;
                for (int comp = 0; comp < 2; comp++) {
                    int32_t *grid = nz_chroma + (int64_t)comp * mbh * 2 * cw;
                    for (int by = 0; by < 2; by++) {
                        for (int bx = 0; bx < 2; bx++) {
                            int y = cy + by, x = cx + bx;
                            if (cbp_chroma != 2) {
                                grid[y * cw + x] = 0;
                                continue;
                            }
                            const int32_t *b = cac[comp] + ((by * 2 + bx) << 4);
                            int nc = nc_of(x > 0, x > 0 ? grid[y * cw + x - 1] : 0,
                                           y > 0, y > 0 ? grid[(y - 1) * cw + x] : 0);
                            for (int i = 1; i < 16; i++)
                                scan[i - 1] = b[ZIGZAG16[i]];
                            int tc = encode_residual(&w, scan, 15, nc);
                            grid[y * cw + x] = tc;
                        }
                    }
                }
            } else {
                /* nz grids for an uncoded MB: all zero */
                int gy = my * 4, gx = mx * 4;
                for (int by = 0; by < 4; by++)
                    for (int bx = 0; bx < 4; bx++)
                        nz_luma[(gy + by) * gw + gx + bx] = 0;
                int cy = my * 2, cx = mx * 2;
                for (int comp = 0; comp < 2; comp++) {
                    int32_t *grid = nz_chroma + (int64_t)comp * mbh * 2 * cw;
                    for (int by = 0; by < 2; by++)
                        for (int bx = 0; bx < 2; bx++)
                            grid[(cy + by) * cw + cx + bx] = 0;
                }
            }
            if (w.overflow) return -1;
        }
    }
    if (skip_run) bw_put_ue(&w, skip_run);      /* trailing skips */

    bw_put(&w, 1, 1);
    if (w.nbits & 7) bw_put(&w, 0, 8 - (w.nbits & 7));
    bw_flush_bytes(&w);
    if (w.overflow || w.nbits != 0) return -1;
    return w.nbytes;
}

/* Emulation-prevention escaping (H.264 7.4.1): out must have capacity
 * for worst case 3n/2. Returns escaped length. */
int64_t vt_escape_emulation(const uint8_t *in, int64_t n, uint8_t *out) {
    int64_t j = 0;
    int zeros = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = in[i];
        if (zeros >= 2 && b <= 3) {
            out[j++] = 3;
            zeros = 0;
        }
        out[j++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    return j;
}

#ifdef __cplusplus
}
#endif
