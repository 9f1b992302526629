/* H.264 CABAC slice coders — C port of codecs/h264/cabac_enc.py.
 *
 * Same role as cavlc.c's slice coders: the production host entropy
 * stage, bit-exact with the Python reference (tests/test_h264_cabac.py
 * asserts equality and oracles against libavcodec). Covers the
 * I_16x16 / P_L0_16x16 + P_Skip envelope.
 *
 * Engine: cabac_engine.h (shared with the HEVC coder; the arithmetic
 * tables are identical in both standards). Context init pairs come
 * from the generated H264 include; zigzag/block-order tables from the
 * CAVLC generated include.
 */

#include <stdint.h>
#include <string.h>

#ifndef VT_HEVC_TABLES_INC
#define VT_HEVC_TABLES_INC "hevc_tables.inc"
#endif
#include VT_HEVC_TABLES_INC          /* engine tables (shared) */
#ifndef VT_H264_CABAC_INC
#define VT_H264_CABAC_INC "h264_cabac_tables.inc"
#endif
#include VT_H264_CABAC_INC
#ifndef VT_TABLES_INC
#define VT_TABLES_INC "cavlc_tables.inc"
#endif
#include VT_TABLES_INC               /* ZIGZAG16, LUMA_ORDER */
#include "cabac_engine.h"

static void h264_cabac_init(Cabac *c, int qp, int i_slice,
                            uint8_t *out, int64_t cap) {
    cab_start(c, out, cap);
    const int8_t *tab = i_slice ? H264_INIT_I : H264_INIT_P0;
    if (qp < 0) qp = 0; if (qp > 51) qp = 51;
    for (int i = 0; i < 1024; i++) {
        int m = tab[2 * i], n = tab[2 * i + 1];
        int pre = ((m * qp) >> 4) + n;
        if (pre < 1) pre = 1; if (pre > 126) pre = 126;
        if (pre <= 63) { c->pstate[i] = (uint8_t)(63 - pre); c->mps[i] = 0; }
        else { c->pstate[i] = (uint8_t)(pre - 64); c->mps[i] = 1; }
    }
}

/* ------------------------------------------------------- residual */

static const int CBF_CAT[5] = {0, 4, 8, 12, 16};
static const int SIGLAST_CAT[5] = {0, 15, 29, 44, 47};
static const int LVL_CAT[5] = {0, 10, 20, 30, 39};

/* coeffs: scan order, length n (<=16). Returns the cbf bit. */
static int residual_block(Cabac *c, int cat, const int32_t *coeffs, int n,
                          int cbf_inc) {
    int nz[16], nnz = 0;
    for (int i = 0; i < n; i++) if (coeffs[i]) nz[nnz++] = i;
    cab_bin(c, 85 + CBF_CAT[cat] + cbf_inc, nnz > 0);
    if (!nnz) return 0;
    int last = nz[nnz - 1];
    for (int i = 0; i < n - 1; i++) {
        int inc = (cat == 3 && i > 2) ? 2 : i;
        int sig = coeffs[i] != 0;
        cab_bin(c, 105 + SIGLAST_CAT[cat] + inc, sig);
        if (sig) {
            cab_bin(c, 166 + SIGLAST_CAT[cat] + inc, i == last);
            if (i == last) break;
        }
    }
    int num_eq1 = 0, num_gt1 = 0;
    for (int k = nnz - 1; k >= 0; k--) {
        int32_t v = coeffs[nz[k]];
        int val = (v < 0 ? -v : v) - 1;
        int base = 227 + LVL_CAT[cat];
        int inc0 = num_gt1 > 0 ? 0
                   : (1 + num_eq1 > 4 ? 4 : 1 + num_eq1);
        cab_bin(c, base + inc0, val > 0);
        if (val > 0) {
            int inc_gt = 5 + (num_gt1 > 4 ? 4 : num_gt1);
            int prefix = val < 14 ? val : 14;
            for (int j = 1; j < prefix; j++) cab_bin(c, base + inc_gt, 1);
            if (val < 14) cab_bin(c, base + inc_gt, 0);
            else cab_eg_bypass(c, val - 14, 0);
            num_gt1++;
        } else num_eq1++;
        cab_bypass(c, v < 0);
    }
    return 1;
}

/* scratch-backed neighbor grids */
typedef struct {
    int mbh, mbw;
    int32_t *cbf_lumadc;   /* (mbh, mbw) */
    int32_t *cbf_luma44;   /* (4mbh, 4mbw) */
    int32_t *cbf_chdc;     /* (2, mbh, mbw) */
    int32_t *cbf_ch44;     /* (2, 2mbh, 2mbw) */
    int32_t *cbp_chroma;   /* (mbh, mbw) */
    int32_t *mvd;          /* (mbh, mbw, 2) abs */
    int32_t *cbp8;         /* (2mbh, 2mbw) */
    int32_t *skip;         /* (mbh, mbw) */
} Grids;

static Grids grids_at(int32_t *scratch, int mbh, int mbw) {
    Grids g;
    g.mbh = mbh; g.mbw = mbw;
    int64_t mb = (int64_t)mbh * mbw;
    g.cbf_lumadc = scratch;             scratch += mb;
    g.cbf_luma44 = scratch;             scratch += mb * 16;
    g.cbf_chdc = scratch;               scratch += mb * 2;
    g.cbf_ch44 = scratch;               scratch += mb * 8;
    g.cbp_chroma = scratch;             scratch += mb;
    g.mvd = scratch;                    scratch += mb * 2;
    g.cbp8 = scratch;                   scratch += mb * 4;
    g.skip = scratch;                   scratch += mb;
    memset(g.cbf_lumadc, 0, sizeof(int32_t) * mb * 35);
    return g;
}

/* cbf ctxIdxInc per category (mirrors cabac_enc.py _cbf_inc; the
 * outside-picture default for intra MBs is condTerm=1) */
static int cbf_inc(const Grids *g, int cat, int my, int mx, int comp,
                   int by, int bx, int cur_intra, int i_slice) {
    int a, b;
    int edge = cur_intra ? 1 : 0;
    if (cat == 0) {
        a = mx > 0 ? (i_slice ? (int)g->cbf_lumadc[my * g->mbw + mx - 1]
                              : 0)
                   : edge;
        b = my > 0 ? (i_slice ? (int)g->cbf_lumadc[(my - 1) * g->mbw + mx]
                              : 0)
                   : edge;
        return a + 2 * b;
    }
    if (cat == 1 || cat == 2) {
        int y = my * 4 + by, x = mx * 4 + bx, w = g->mbw * 4;
        a = x > 0 ? (int)g->cbf_luma44[y * w + x - 1] : edge;
        b = y > 0 ? (int)g->cbf_luma44[(y - 1) * w + x] : edge;
        return a + 2 * b;
    }
    if (cat == 3) {
        a = mx > 0 ? (int)g->cbf_chdc[(comp * g->mbh + my) * g->mbw + mx - 1]
                   : edge;
        b = my > 0 ? (int)g->cbf_chdc[(comp * g->mbh + my - 1) * g->mbw + mx]
                   : edge;
        return a + 2 * b;
    }
    {
        int y = my * 2 + by, x = mx * 2 + bx, w = g->mbw * 2;
        const int32_t *grid = g->cbf_ch44 + (int64_t)comp * g->mbh * 2 * w;
        a = x > 0 ? (int)grid[y * w + x - 1] : edge;
        b = y > 0 ? (int)grid[(y - 1) * w + x] : edge;
        return a + 2 * b;
    }
}

static void scan16(const int32_t *blk, int32_t *out) {
    for (int i = 0; i < 16; i++) out[i] = blk[ZIGZAG16[i]];
}

static void qp_delta_zero(Cabac *c, int *prev_nz) {
    cab_bin(c, 60 + (*prev_nz ? 1 : 0), 0);
    *prev_nz = 0;
}

/* ------------------------------------------------------- I slices */

static int64_t encode_i_slice(
        const int32_t *luma_dc, const int32_t *luma_ac,
        const int32_t *chroma_dc, const int32_t *chroma_ac,
        int mbh, int mbw, int slice_qp,
        int32_t *scratch, uint8_t *out, int64_t out_cap)
{
    Cabac c;
    h264_cabac_init(&c, slice_qp, 1, out, out_cap);
    Grids g = grids_at(scratch, mbh, mbw);
    int prev_qp_nz = 0;
    int32_t sc[16];
    for (int my = 0; my < mbh; my++)
        for (int mx = 0; mx < mbw; mx++) {
            int mb = my * mbw + mx;
            const int32_t *dc = luma_dc + (int64_t)mb * 16;
            const int32_t *ac = luma_ac + (int64_t)mb * 256;
            int cbp_luma = 0;
            for (int i = 0; i < 256 && !cbp_luma; i++)
                if (ac[i]) cbp_luma = 15;
            int cbp_chroma = 0;
            for (int comp = 0; comp < 2 && cbp_chroma < 2; comp++) {
                const int32_t *cac = chroma_ac
                    + ((int64_t)comp * mbh * mbw + mb) * 64;
                for (int i = 0; i < 64; i++)
                    if (cac[i]) { cbp_chroma = 2; break; }
            }
            if (!cbp_chroma)
                for (int comp = 0; comp < 2 && !cbp_chroma; comp++) {
                    const int32_t *cdc = chroma_dc
                        + ((int64_t)comp * mbh * mbw + mb) * 4;
                    for (int i = 0; i < 4; i++)
                        if (cdc[i]) { cbp_chroma = 1; break; }
                }
            int luma_mode = my == 0 ? 2 : 0;
            int chroma_mode = my == 0 ? 0 : 2;

            /* mb_type: neighbors are always I16 in an I slice */
            int ca = mx > 0 ? 1 : 0, cb = my > 0 ? 1 : 0;
            cab_bin(&c, 3 + ca + cb, 1);
            cab_terminate(&c, 0);
            cab_bin(&c, 6, cbp_luma ? 1 : 0);
            cab_bin(&c, 7, cbp_chroma ? 1 : 0);
            if (cbp_chroma) cab_bin(&c, 8, cbp_chroma == 2);
            cab_bin(&c, 9, (luma_mode >> 1) & 1);
            cab_bin(&c, 10, luma_mode & 1);

            /* intra_chroma_pred_mode (neighbors' mode: row0 DC=0) */
            {
                int ia = mx > 0 && (my != 0) ? 1 : 0;  /* left mode!=0 */
                int ib = my > 1 ? 1 : 0;               /* above mode!=0 */
                cab_bin(&c, 64 + ia + ib, chroma_mode > 0);
                if (chroma_mode > 0) {
                    cab_bin(&c, 67, chroma_mode > 1);
                    if (chroma_mode > 1) cab_bin(&c, 67, chroma_mode > 2);
                }
            }
            qp_delta_zero(&c, &prev_qp_nz);

            scan16(dc, sc);
            g.cbf_lumadc[mb] = residual_block(
                &c, 0, sc, 16, cbf_inc(&g, 0, my, mx, 0, 0, 0, 1, 1));
            if (cbp_luma)
                for (int k = 0; k < 16; k++) {
                    int by = LUMA_ORDER[k] / 4, bx = LUMA_ORDER[k] % 4;
                    const int32_t *blk = ac + ((by * 4 + bx) << 4);
                    scan16(blk, sc);
                    int cbf = residual_block(
                        &c, 1, sc + 1, 15,
                        cbf_inc(&g, 1, my, mx, 0, by, bx, 1, 1));
                    g.cbf_luma44[(my * 4 + by) * mbw * 4 + mx * 4 + bx]
                        = cbf;
                }
            if (cbp_chroma > 0)
                for (int comp = 0; comp < 2; comp++) {
                    const int32_t *cdc = chroma_dc
                        + ((int64_t)comp * mbh * mbw + mb) * 4;
                    g.cbf_chdc[(comp * mbh + my) * mbw + mx]
                        = residual_block(
                            &c, 3, cdc, 4,
                            cbf_inc(&g, 3, my, mx, comp, 0, 0, 1, 1));
                }
            if (cbp_chroma == 2)
                for (int comp = 0; comp < 2; comp++)
                    for (int by = 0; by < 2; by++)
                        for (int bx = 0; bx < 2; bx++) {
                            const int32_t *blk = chroma_ac
                                + (((int64_t)comp * mbh * mbw + mb) * 4
                                   + by * 2 + bx) * 16;
                            scan16(blk, sc);
                            int cbf = residual_block(
                                &c, 4, sc + 1, 15,
                                cbf_inc(&g, 4, my, mx, comp, by, bx, 1, 1));
                            g.cbf_ch44[((int64_t)comp * mbh * 2
                                        + my * 2 + by) * mbw * 2
                                       + mx * 2 + bx] = cbf;
                        }
            g.cbp_chroma[mb] = cbp_chroma;
            cab_terminate(&c, my == mbh - 1 && mx == mbw - 1);
        }
    return cab_finish(&c);
}

extern "C" int64_t vt_h264_cabac_i_slice(
        const int32_t *luma_dc, const int32_t *luma_ac,
        const int32_t *chroma_dc, const int32_t *chroma_ac,
        int mbh, int mbw, int slice_qp,
        const uint8_t *header_bytes, int64_t n_header_bytes,
        int32_t *scratch, uint8_t *out, int64_t out_cap)
{
    if (n_header_bytes > out_cap) return -1;
    memcpy(out, header_bytes, (size_t)n_header_bytes);
    int64_t n = encode_i_slice(luma_dc, luma_ac, chroma_dc, chroma_ac,
                               mbh, mbw, slice_qp, scratch,
                               out + n_header_bytes,
                               out_cap - n_header_bytes);
    return n < 0 ? -1 : n + n_header_bytes;
}

/* ------------------------------------------------------- P slices */

static void median_pred(const int32_t *mvs, int mbh, int mbw, int my,
                        int mx, int32_t *px, int32_t *py) {
    /* same rules as cavlc.c mv_pred (8.4.1.3.1) */
    int a_ok = mx > 0, b_ok = my > 0;
    int c_ok = b_ok && mx < mbw - 1, d_ok = b_ok && mx > 0;
    int32_t ax = 0, ay = 0, bx = 0, by = 0, cx = 0, cy = 0;
    int cav = 0;
    if (a_ok) { ax = mvs[(my * mbw + mx - 1) * 2];
                ay = mvs[(my * mbw + mx - 1) * 2 + 1]; }
    if (b_ok) { bx = mvs[((my - 1) * mbw + mx) * 2];
                by = mvs[((my - 1) * mbw + mx) * 2 + 1]; }
    if (c_ok) { cav = 1; cx = mvs[((my - 1) * mbw + mx + 1) * 2];
                cy = mvs[((my - 1) * mbw + mx + 1) * 2 + 1]; }
    else if (d_ok) { cav = 1; cx = mvs[((my - 1) * mbw + mx - 1) * 2];
                     cy = mvs[((my - 1) * mbw + mx - 1) * 2 + 1]; }
    int n_avail = a_ok + b_ok + cav;
    if (n_avail == 1) {
        if (a_ok) { *px = ax; *py = ay; }
        else if (b_ok) { *px = bx; *py = by; }
        else { *px = cx; *py = cy; }
        return;
    }
#define MED3(a, b, cc) ((a) > (b) ? ((b) > (cc) ? (b) : ((a) > (cc) ? (cc) \
    : (a))) : ((a) > (cc) ? (a) : ((b) > (cc) ? (cc) : (b))))
    *px = MED3(ax, bx, cx);
    *py = MED3(ay, by, cy);
#undef MED3
}

static void skip_pred(const int32_t *mvs, int mbh, int mbw, int my,
                      int mx, int32_t *px, int32_t *py) {
    if (mx == 0 || my == 0) { *px = 0; *py = 0; return; }
    const int32_t *a = mvs + ((int64_t)my * mbw + mx - 1) * 2;
    const int32_t *b = mvs + (((int64_t)my - 1) * mbw + mx) * 2;
    if ((a[0] == 0 && a[1] == 0) || (b[0] == 0 && b[1] == 0)) {
        *px = 0; *py = 0; return;
    }
    median_pred(mvs, mbh, mbw, my, mx, px, py);
}

static void encode_mvd_comp(Cabac *c, int mvd, int amvd, int base) {
    int inc = amvd < 3 ? 0 : (amvd <= 32 ? 1 : 2);
    int val = mvd < 0 ? -mvd : mvd;
    cab_bin(c, base + inc, val > 0);
    if (val > 0) {
        int prefix = val < 9 ? val : 9;
        for (int k = 1; k < prefix; k++)
            cab_bin(c, base + 2 + (k < 4 ? k : 4), 1);
        if (val < 9)
            cab_bin(c, base + 2 + (prefix < 4 ? prefix : 4), 0);
        else cab_eg_bypass(c, val - 9, 3);
        cab_bypass(c, mvd < 0);
    }
}

extern "C" int64_t vt_h264_cabac_p_slice(
        const int32_t *luma, const int32_t *chroma_dc,
        const int32_t *chroma_ac, const int32_t *mv,
        int mbh, int mbw, int slice_qp,
        const uint8_t *header_bytes, int64_t n_header_bytes,
        int32_t *scratch, uint8_t *out, int64_t out_cap)
{
    if (n_header_bytes > out_cap) return -1;
    memcpy(out, header_bytes, (size_t)n_header_bytes);
    Cabac c;
    h264_cabac_init(&c, slice_qp, 0, out + n_header_bytes,
                    out_cap - n_header_bytes);
    Grids g = grids_at(scratch, mbh, mbw);
    int64_t mbs = (int64_t)mbh * mbw;
    int32_t *mvs = scratch + mbs * 35;   /* reconstructed (x, y) qpel */
    memset(mvs, 0, sizeof(int32_t) * mbs * 2);
    int prev_qp_nz = 0;
    int32_t sc[16];
    static const int BLK2[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};

    for (int my = 0; my < mbh; my++)
        for (int mx = 0; mx < mbw; mx++) {
            int mb = my * mbw + mx;
            const int32_t *lu = luma + (int64_t)mb * 256;
            int32_t mvx = mv[mb * 2 + 1], mvy = mv[mb * 2];
            int cbp = 0;
            for (int i8 = 0; i8 < 4; i8++) {
                int oy = BLK2[i8][0], ox = BLK2[i8][1], any = 0;
                for (int s = 0; s < 4 && !any; s++) {
                    int by = 2 * oy + BLK2[s][0], bx = 2 * ox + BLK2[s][1];
                    const int32_t *blk = lu + ((by * 4 + bx) << 4);
                    for (int i = 0; i < 16; i++)
                        if (blk[i]) { any = 1; break; }
                }
                if (any) cbp |= 1 << i8;
            }
            int cbp_chroma = 0;
            for (int comp = 0; comp < 2 && cbp_chroma < 2; comp++) {
                const int32_t *cac = chroma_ac
                    + ((int64_t)comp * mbs + mb) * 64;
                for (int i = 0; i < 64; i++)
                    if (cac[i]) { cbp_chroma = 2; break; }
            }
            if (!cbp_chroma)
                for (int comp = 0; comp < 2 && !cbp_chroma; comp++) {
                    const int32_t *cdc = chroma_dc
                        + ((int64_t)comp * mbs + mb) * 4;
                    for (int i = 0; i < 4; i++)
                        if (cdc[i]) { cbp_chroma = 1; break; }
                }
            int32_t smx, smy;
            skip_pred(mvs, mbh, mbw, my, mx, &smx, &smy);
            int skip = cbp == 0 && cbp_chroma == 0
                && mvx == smx && mvy == smy;
            int ca = mx > 0 && !g.skip[mb - 1] ? 1 : 0;
            int cb = my > 0 && !g.skip[mb - mbw] ? 1 : 0;
            cab_bin(&c, 11 + ca + cb, skip);
            if (skip) {
                mvs[mb * 2] = smx; mvs[mb * 2 + 1] = smy;
                g.skip[mb] = 1;
                cab_terminate(&c, my == mbh - 1 && mx == mbw - 1);
                continue;
            }
            cab_bin(&c, 14, 0);
            cab_bin(&c, 15, 0);
            cab_bin(&c, 16, 0);

            int32_t px, py;
            median_pred(mvs, mbh, mbw, my, mx, &px, &py);
            mvs[mb * 2] = mvx; mvs[mb * 2 + 1] = mvy;
            {
                int amvd_x = (mx > 0 ? g.mvd[(mb - 1) * 2] : 0)
                    + (my > 0 ? g.mvd[(mb - mbw) * 2] : 0);
                int amvd_y = (mx > 0 ? g.mvd[(mb - 1) * 2 + 1] : 0)
                    + (my > 0 ? g.mvd[(mb - mbw) * 2 + 1] : 0);
                int dx = mvx - px, dy = mvy - py;
                encode_mvd_comp(&c, dx, amvd_x, 40);
                encode_mvd_comp(&c, dy, amvd_y, 47);
                g.mvd[mb * 2] = dx < 0 ? -dx : dx;
                g.mvd[mb * 2 + 1] = dy < 0 ? -dy : dy;
            }

            for (int i8 = 0; i8 < 4; i8++) {
                int y8 = my * 2 + BLK2[i8][0], x8 = mx * 2 + BLK2[i8][1];
                int w8 = mbw * 2;
                int a = x8 > 0 && g.cbp8[y8 * w8 + x8 - 1] == 0 ? 1 : 0;
                int b = y8 > 0 && g.cbp8[(y8 - 1) * w8 + x8] == 0 ? 1 : 0;
                int bit = (cbp >> i8) & 1;
                cab_bin(&c, 73 + a + 2 * b, bit);
                g.cbp8[y8 * w8 + x8] = bit;
            }
            {
                int a = mx > 0 && g.cbp_chroma[mb - 1] != 0 ? 1 : 0;
                int b = my > 0 && g.cbp_chroma[mb - mbw] != 0 ? 1 : 0;
                cab_bin(&c, 77 + a + 2 * b, cbp_chroma ? 1 : 0);
                if (cbp_chroma) {
                    a = mx > 0 && g.cbp_chroma[mb - 1] == 2 ? 1 : 0;
                    b = my > 0 && g.cbp_chroma[mb - mbw] == 2 ? 1 : 0;
                    cab_bin(&c, 81 + a + 2 * b, cbp_chroma == 2);
                }
                g.cbp_chroma[mb] = cbp_chroma;
            }
            int full_cbp = cbp | (cbp_chroma << 4);
            if (full_cbp) {
                qp_delta_zero(&c, &prev_qp_nz);
                for (int i8 = 0; i8 < 4; i8++)
                    for (int s = 0; s < 4; s++) {
                        int by = 2 * BLK2[i8][0] + BLK2[s][0];
                        int bx = 2 * BLK2[i8][1] + BLK2[s][1];
                        int gy = my * 4 + by, gx = mx * 4 + bx;
                        if (!((cbp >> i8) & 1)) {
                            g.cbf_luma44[gy * mbw * 4 + gx] = 0;
                            continue;
                        }
                        const int32_t *blk = lu + ((by * 4 + bx) << 4);
                        scan16(blk, sc);
                        int cbf = residual_block(
                            &c, 2, sc, 16,
                            cbf_inc(&g, 2, my, mx, 0, by, bx, 0, 0));
                        g.cbf_luma44[gy * mbw * 4 + gx] = cbf;
                    }
                if (cbp_chroma > 0)
                    for (int comp = 0; comp < 2; comp++) {
                        const int32_t *cdc = chroma_dc
                            + ((int64_t)comp * mbs + mb) * 4;
                        g.cbf_chdc[(comp * mbh + my) * mbw + mx]
                            = residual_block(
                                &c, 3, cdc, 4,
                                cbf_inc(&g, 3, my, mx, comp, 0, 0, 0, 0));
                    }
                for (int comp = 0; comp < 2; comp++)
                    for (int by = 0; by < 2; by++)
                        for (int bx = 0; bx < 2; bx++) {
                            int64_t idx = ((int64_t)comp * mbh * 2
                                           + my * 2 + by) * mbw * 2
                                + mx * 2 + bx;
                            if (cbp_chroma != 2) {
                                g.cbf_ch44[idx] = 0;
                                continue;
                            }
                            const int32_t *blk = chroma_ac
                                + (((int64_t)comp * mbs + mb) * 4
                                   + by * 2 + bx) * 16;
                            scan16(blk, sc);
                            g.cbf_ch44[idx] = residual_block(
                                &c, 4, sc + 1, 15,
                                cbf_inc(&g, 4, my, mx, comp, by, bx, 0, 0));
                        }
            }
            cab_terminate(&c, my == mbh - 1 && mx == mbw - 1);
        }
    int64_t n = cab_finish(&c);
    return n < 0 ? -1 : n + n_header_bytes;
}
