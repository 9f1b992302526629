/* HEVC CABAC slice coder — C port of codecs/hevc/{cabac,residual,slice}.py.
 *
 * Same role as cavlc.c for the H.264 path: the device (JAX) produces
 * quantized coefficient levels per CTB; this packs one whole I-slice's
 * CABAC payload on the host at C speed.  Bit-exactness with the Python
 * reference is asserted by tests/test_hevc.py (and transitively with
 * libavcodec by the oracle tests there).
 *
 * Stream shape (see codecs/hevc/syntax.py): 32x32 CTB == CU, 2Nx2N
 * intra mode 26, one 32x32 luma TB + two 16x16 chroma TBs, no SAO/
 * deblock/transform-skip/sign-hiding, diagonal scans only.
 */

#include <stdint.h>
#include <string.h>

#ifndef VT_HEVC_TABLES_INC
#define VT_HEVC_TABLES_INC "hevc_tables.inc"
#endif
#include VT_HEVC_TABLES_INC
#include "cabac_engine.h"

/* engine lives in cabac_engine.h (shared with h264_cabac_enc.c) */
#define enc_bin cab_bin
#define enc_bypass cab_bypass
#define enc_bypass_bits cab_bypass_bits
#define enc_terminate cab_terminate
#define cabac_finish cab_finish

static void cabac_init(Cabac *c, int qp, int init_type, uint8_t *out,
                       int64_t cap) {
    cab_start(c, out, cap);
    if (qp < 0) qp = 0; if (qp > 51) qp = 51;
    for (int i = 0; i < 199; i++) {
        int init_value = init_type ? HEVC_INIT_P[i] : HEVC_INIT_I[i];
        int slope = (init_value >> 4) * 5 - 45;
        int offset = ((init_value & 15) << 3) - 16;
        int pre = ((slope * qp) >> 4) + offset;
        if (pre < 1) pre = 1; if (pre > 126) pre = 126;
        if (pre <= 63) { c->pstate[i] = (uint8_t)(63 - pre); c->mps[i] = 0; }
        else { c->pstate[i] = (uint8_t)(pre - 64); c->mps[i] = 1; }
    }
}

/* ------------------------------------------------------------- residual */

static const uint8_t GROUP_IDX[32] = {0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,
                                      8,8,8,8,8,8,8,8,9,9,9,9,9,9,9,9};
static const uint8_t MIN_IN_GROUP[10] = {0,1,2,3,4,6,8,12,16,24};

/* whole-TB forward scans (HEVC_SCAN32/HEVC_SCAN16) come precomputed
 * from the generated header: constant data, safe under the entropy
 * thread pool with no init ordering to get wrong. */

static void write_last_prefix(Cabac *c, int group, int cmax, int base,
                              int offset, int shift) {
    for (int b = 0; b < group; b++)
        enc_bin(c, base + offset + (b >> shift), 1);
    if (group < cmax)
        enc_bin(c, base + offset + (group >> shift), 0);
}

static void write_remaining(Cabac *c, int value, int rice) {
    if (value < (3 << rice)) {
        for (int i = 0; i < (value >> rice); i++) enc_bypass(c, 1);
        enc_bypass(c, 0);
        if (rice) enc_bypass_bits(c, value & ((1 << rice) - 1), rice);
    } else {
        int length = rice;
        value -= 3 << rice;
        while (value >= (1 << length)) { value -= 1 << length; length++; }
        for (int i = 0; i < 3 + length - rice; i++) enc_bypass(c, 1);
        enc_bypass(c, 0);
        if (length) enc_bypass_bits(c, (uint32_t)value, length);
    }
}

static int sig_ctx(int x, int y, int c_idx, int prev_csbf) {
    if (x == 0 && y == 0) return c_idx == 0 ? 0 : 27;
    int xp = x & 3, yp = y & 3, s;
    if (prev_csbf == 0)      s = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
    else if (prev_csbf == 1) s = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
    else if (prev_csbf == 2) s = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
    else                     s = 2;
    if (c_idx == 0) {
        if ((x >> 2) || (y >> 2)) s += 3;
        return s + 21;
    }
    return 27 + s + 12;
}

/* levels: raster (N, N) int16; at least one nonzero */
static void write_residual(Cabac *c, const int16_t *lv, int log2_size,
                           int c_idx) {
    const int n = 1 << log2_size, n_cg = n >> 2;
    const int16_t *scan = (n == 32) ? HEVC_SCAN32 : HEVC_SCAN16;
    const uint8_t *cg_scan = (n_cg == 8) ? HEVC_DIAG8 : HEVC_DIAG4;

    int last_scan = -1;
    for (int i = n * n - 1; i >= 0; i--)
        if (lv[scan[i]]) { last_scan = i; break; }
    int last_x = scan[last_scan] % n, last_y = scan[last_scan] / n;

    int cmax = (log2_size << 1) - 1, offset, shift;
    if (c_idx == 0) {
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
        shift = (log2_size + 1) >> 2;
    } else { offset = 15; shift = log2_size - 2; }
    int gx = GROUP_IDX[last_x], gy = GROUP_IDX[last_y];
    write_last_prefix(c, gx, cmax, HEVC_CTX_LAST_X_PREFIX, offset, shift);
    write_last_prefix(c, gy, cmax, HEVC_CTX_LAST_Y_PREFIX, offset, shift);
    if (gx > 3)
        enc_bypass_bits(c, (uint32_t)(last_x - MIN_IN_GROUP[gx]),
                        (gx >> 1) - 1);
    if (gy > 3)
        enc_bypass_bits(c, (uint32_t)(last_y - MIN_IN_GROUP[gy]),
                        (gy >> 1) - 1);

    uint8_t csbf[64];
    for (int cy = 0; cy < n_cg; cy++)
        for (int cx = 0; cx < n_cg; cx++) {
            int any = 0;
            for (int yy = 0; yy < 4 && !any; yy++)
                for (int xx = 0; xx < 4; xx++)
                    if (lv[(cy * 4 + yy) * n + cx * 4 + xx]) { any = 1; break; }
            csbf[cy * n_cg + cx] = (uint8_t)any;
        }

    int last_cg = last_scan >> 4;
    int greater1_ctx = 1, first_cg_done = 0;
    for (int ci = last_cg; ci >= 0; ci--) {
        int cx = cg_scan[ci] >> 4, cy = cg_scan[ci] & 15;
        int coded = csbf[cy * n_cg + cx];
        int is_explicit = (ci != last_cg && ci != 0);
        int right = (cx + 1 < n_cg) && csbf[cy * n_cg + cx + 1];
        int below = (cy + 1 < n_cg) && csbf[(cy + 1) * n_cg + cx];
        if (is_explicit) {
            enc_bin(c, HEVC_CTX_SIG_CG_FLAG + (c_idx ? 2 : 0)
                       + ((right || below) ? 1 : 0), coded);
            if (!coded) continue;
        }
        int prev_csbf = right + 2 * below;

        int start = (ci == last_cg) ? (last_scan % 16) - 1 : 15;
        int infer_dc = is_explicit;
        int sig_pos[16], nsig = 0;       /* coding order (reverse scan) */
        if (ci == last_cg) sig_pos[nsig++] = scan[last_scan];
        for (int j = start; j >= 0; j--) {
            int pos = scan[(ci << 4) + j];
            int significant = lv[pos] != 0;
            if (j == 0 && infer_dc && nsig == 0) {
                sig_pos[nsig++] = pos;   /* inferred 1 */
                continue;
            }
            enc_bin(c, HEVC_CTX_SIG_COEFF
                       + sig_ctx(pos % n, pos / n, c_idx, prev_csbf),
                    significant);
            if (significant) sig_pos[nsig++] = pos;
        }
        if (!nsig) continue;             /* all-zero CG0 */

        int ctx_set = (ci > 0 && c_idx == 0) ? 2 : 0;
        if (first_cg_done && greater1_ctx == 0) ctx_set++;
        first_cg_done = 1;
        greater1_ctx = 1;
        int g1_flags[8], g2_pos = -1;
        int ng1 = nsig < 8 ? nsig : 8;
        for (int k = 0; k < ng1; k++) {
            int absl = lv[sig_pos[k]] < 0 ? -lv[sig_pos[k]] : lv[sig_pos[k]];
            int flag = absl > 1;
            int base = HEVC_CTX_GREATER1 + (c_idx ? 16 : 0);
            int c1m = greater1_ctx < 3 ? greater1_ctx : 3;
            enc_bin(c, base + ctx_set * 4 + c1m, flag);
            g1_flags[k] = flag;
            if (flag) {
                if (g2_pos < 0) g2_pos = k;
                greater1_ctx = 0;
            } else if (greater1_ctx > 0 && greater1_ctx < 3) greater1_ctx++;
        }
        int g2_flag = 0;
        if (g2_pos >= 0) {
            int absl = lv[sig_pos[g2_pos]] < 0 ? -lv[sig_pos[g2_pos]]
                                               : lv[sig_pos[g2_pos]];
            g2_flag = absl > 2;
            enc_bin(c, HEVC_CTX_GREATER2 + (c_idx ? 4 + ctx_set : ctx_set),
                    g2_flag);
        }
        for (int k = 0; k < nsig; k++)
            enc_bypass(c, lv[sig_pos[k]] < 0);
        int rice = 0;
        for (int k = 0; k < nsig; k++) {
            int absl = lv[sig_pos[k]] < 0 ? -lv[sig_pos[k]] : lv[sig_pos[k]];
            int base_level;
            if (k < 8) {
                if (!g1_flags[k]) continue;
                if (k == g2_pos) {
                    if (!g2_flag) continue;
                    base_level = 3;
                } else base_level = 2;
            } else base_level = 1;
            write_remaining(c, absl - base_level, rice);
            if (absl > (3 << rice) && rice < 4) rice++;
        }
    }
}

/* -------------------------------------------------------------- slice */

static int any_nonzero(const int16_t *lv, int count) {
    for (int i = 0; i < count; i++) if (lv[i]) return 1;
    return 0;
}

/* One 32x32 intra CTU (see slice.py for the bin-by-bin derivation). */
static void write_ctu(Cabac *c, int col, const int16_t *luma,
                      const int16_t *cb, const int16_t *cr, int last) {
    enc_bin(c, HEVC_CTX_PART_MODE, 1);          /* 2Nx2N */
    enc_bin(c, HEVC_CTX_PREV_INTRA_LUMA, 1);    /* always an MPM hit */
    if (col == 0) { enc_bypass(c, 1); enc_bypass(c, 1); }  /* mpm_idx 2 */
    else enc_bypass(c, 0);                                  /* mpm_idx 0 */
    enc_bin(c, HEVC_CTX_INTRA_CHROMA_PRED, 0);  /* DM */

    int cbf_cb = cb && any_nonzero(cb, 256);
    int cbf_cr = cr && any_nonzero(cr, 256);
    int cbf_luma = luma && any_nonzero(luma, 1024);
    enc_bin(c, HEVC_CTX_CBF_CB_CR, cbf_cb);
    enc_bin(c, HEVC_CTX_CBF_CB_CR, cbf_cr);
    enc_bin(c, HEVC_CTX_CBF_LUMA + 1, cbf_luma);
    if (cbf_luma) write_residual(c, luma, 5, 0);
    if (cbf_cb) write_residual(c, cb, 4, 1);
    if (cbf_cr) write_residual(c, cr, 4, 2);
    enc_terminate(c, last);
}

/* ----------------------------------------------------------- entry point
 * luma: rows*cols blocks of 1024 int16 (raster within block);
 * cb/cr: rows*cols blocks of 256. Returns payload size or -1 (overflow).
 */
extern "C" int64_t vt_hevc_encode_slice(
        const int16_t *luma, const int16_t *cb, const int16_t *cr,
        int32_t rows, int32_t cols, int32_t slice_qp,
        uint8_t *out, int64_t out_cap) {
    Cabac c;
    cabac_init(&c, slice_qp, 0, out, out_cap);
    for (int r = 0; r < rows; r++)
        for (int col = 0; col < cols; col++) {
            int i = r * cols + col;
            write_ctu(&c, col, luma + (int64_t)i * 1024,
                      cb + (int64_t)i * 256, cr + (int64_t)i * 256,
                      r == rows - 1 && col == cols - 1);
        }
    return cabac_finish(&c);
}

/* --------------------------------------------------------- P slices
 * Mirror of codecs/hevc/pslice.py: every CTB an inter 2Nx2N CU with an
 * explicitly coded MV (AMVP candidate 0, no merge/skip).
 * mv: (rows*cols, 2) int32 as (y, x) QUARTER luma pels (DSP order).
 */

static void write_mvd(Cabac *c, int dx, int dy) {
    int comps[2] = {dx, dy};
    int g0[2] = {dx != 0, dy != 0};
    int g1[2] = {dx > 1 || dx < -1, dy > 1 || dy < -1};
    enc_bin(c, HEVC_CTX_MVD_GREATER, g0[0]);
    enc_bin(c, HEVC_CTX_MVD_GREATER, g0[1]);
    if (g0[0]) enc_bin(c, HEVC_CTX_MVD_GREATER + 3, g1[0]);
    if (g0[1]) enc_bin(c, HEVC_CTX_MVD_GREATER + 3, g1[1]);
    for (int i = 0; i < 2; i++) {
        int v = comps[i];
        if (!g0[i]) continue;
        if (g1[i]) {
            int rem = (v < 0 ? -v : v) - 2;
            int k = 1;                       /* EG1 bypass */
            while (rem >= (1 << k)) { enc_bypass(c, 1); rem -= 1 << k; k++; }
            enc_bypass(c, 0);
            enc_bypass_bits(c, (uint32_t)rem, k);
        }
        enc_bypass(c, v < 0);
    }
}

extern "C" int64_t vt_hevc_encode_p_slice(
        const int16_t *luma, const int16_t *cb, const int16_t *cr,
        const int32_t *mv,
        int32_t rows, int32_t cols, int32_t slice_qp,
        int32_t *mv_scratch,      /* rows*cols*2, holds (x, y) qpel */
        uint8_t *out, int64_t out_cap) {
    Cabac c;
    cabac_init(&c, slice_qp, 1, out, out_cap);
    for (int r = 0; r < rows; r++)
        for (int col = 0; col < cols; col++) {
            int i = r * cols + col;
            enc_bin(&c, HEVC_CTX_SKIP, 0);          /* cu_skip_flag */
            enc_bin(&c, HEVC_CTX_PRED_MODE, 0);     /* MODE_INTER */
            enc_bin(&c, HEVC_CTX_PART_MODE, 1);     /* 2Nx2N */
            enc_bin(&c, HEVC_CTX_MERGE_FLAG, 0);
            int mvx = mv[i * 2 + 1], mvy = mv[i * 2];
            /* AMVP candidate 0: left CU, else first of B0/B1/B2
             * (every CTB here is inter, so availability is purely
             * positional — matches MvpGrid in an all-inter slice) */
            int px = 0, py = 0;
            if (col > 0) {
                px = mv_scratch[(i - 1) * 2];
                py = mv_scratch[(i - 1) * 2 + 1];
            } else if (r > 0) {
                int j = (r - 1) * cols + col + 1;   /* B0 */
                if (col + 1 >= cols) j = (r - 1) * cols + col;  /* B1 */
                px = mv_scratch[j * 2];
                py = mv_scratch[j * 2 + 1];
            }
            write_mvd(&c, mvx - px, mvy - py);
            enc_bin(&c, HEVC_CTX_MVP_LX, 0);        /* mvp_l0_flag */
            mv_scratch[i * 2] = mvx;
            mv_scratch[i * 2 + 1] = mvy;

            const int16_t *lu = luma + (int64_t)i * 1024;
            const int16_t *ub = cb + (int64_t)i * 256;
            const int16_t *vb = cr + (int64_t)i * 256;
            int cbf_l = any_nonzero(lu, 1024);
            int cbf_cb = any_nonzero(ub, 256);
            int cbf_cr = any_nonzero(vb, 256);
            int root = cbf_l || cbf_cb || cbf_cr;
            enc_bin(&c, HEVC_CTX_NO_RESIDUAL, root); /* rqt_root_cbf */
            if (root) {
                enc_bin(&c, HEVC_CTX_CBF_CB_CR, cbf_cb);
                enc_bin(&c, HEVC_CTX_CBF_CB_CR, cbf_cr);
                if (cbf_cb || cbf_cr)
                    enc_bin(&c, HEVC_CTX_CBF_LUMA + 1, cbf_l);
                /* else: cbf_luma inferred 1 */
                if (cbf_l) write_residual(&c, lu, 5, 0);
                if (cbf_cb) write_residual(&c, ub, 4, 1);
                if (cbf_cr) write_residual(&c, vb, 4, 2);
            }
            enc_terminate(&c, r == rows - 1 && col == cols - 1);
        }
    return cabac_finish(&c);
}
