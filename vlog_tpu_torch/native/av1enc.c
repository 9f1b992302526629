/* AV1 encode shim over the system libavcodec (libaom-av1 / SVT-AV1).
 *
 * The reference's AV1 path is DELEGATED encoding — av1_vaapi selected in
 * worker/hwaccel.py:555-646, hardware/ffmpeg doing the bits. This shim
 * is the same architectural boundary for this framework: H.264 and HEVC
 * are first-party TPU encoders (the methodology demonstrator), while
 * AV1 rides the system encoder libraries. A first-party AV1 entropy
 * coder needs the spec's default CDF tables, which this zero-egress
 * image cannot supply (libaom/libdav1d are stripped, no headers, no
 * static libs to extract from) — see COVERAGE.md row 5.
 *
 * A copy of the JAX package's vlog_tpu/native/av1enc.c (this comment
 * aside). Compiled into libvt_av.so by vlog_tpu_torch/native/build.py
 * (get_av_lib) next to the ingest shim.
 */

#include <libavcodec/avcodec.h>
#include <libavutil/opt.h>
#include <libavutil/imgutils.h>
#include <string.h>

typedef struct {
    AVCodecContext *ctx;
    AVFrame *frame;
    AVPacket *pkt;
    int w, h;
    int64_t next_pts;
    int flushed;
    int held;     /* pkt holds an undelivered packet (buffer was small) */
} VtAv1Enc;

void *vt_av1_open(int w, int h, int fps_num, int fps_den,
                  int64_t bitrate, int gop_len, int speed) {
    const char *names[] = {"libaom-av1", "libsvtav1", "librav1e", NULL};
    const AVCodec *enc = NULL;
    for (int i = 0; names[i] && !enc; i++)
        enc = avcodec_find_encoder_by_name(names[i]);
    if (!enc) return NULL;

    VtAv1Enc *e = calloc(1, sizeof(*e));
    if (!e) return NULL;
    e->ctx = avcodec_alloc_context3(enc);
    e->w = w; e->h = h;
    e->ctx->width = w;
    e->ctx->height = h;
    e->ctx->time_base = (AVRational){fps_den, fps_num};
    e->ctx->framerate = (AVRational){fps_num, fps_den};
    e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
    e->ctx->bit_rate = bitrate;
    /* Bound the one-pass VBR: without maxrate/bufsize the system
     * encoders overshoot freely on hard content and trip the product
     * plane's rate-verification cap (a miss our controller can't
     * influence). 1.5x maxrate over a ~1s window tracks the cap. */
    e->ctx->rc_max_rate = bitrate + bitrate / 2;
    e->ctx->rc_buffer_size = (int)(bitrate + bitrate / 2);
    e->ctx->gop_size = gop_len;
    e->ctx->max_b_frames = 0;
    e->ctx->thread_count = 0;
    /* no GLOBAL_HEADER: the av01 packaging relies on the sequence
     * header OBU riding in-band at every keyframe TU (av1C configOBUs
     * stay empty), so the encoder must not strip it into extradata */
    if (!strcmp(enc->name, "libaom-av1")) {
        char sp[8];
        snprintf(sp, sizeof sp, "%d", speed < 0 ? 6 : speed);
        av_opt_set(e->ctx->priv_data, "cpu-used", sp, 0);
        av_opt_set(e->ctx->priv_data, "row-mt", "1", 0);
        av_opt_set(e->ctx->priv_data, "usage", "good", 0);
        /* no alt-ref lookahead: every packet is one shown frame, so the
         * CMAF sample count tracks the frame count 1:1 */
        av_opt_set(e->ctx->priv_data, "lag-in-frames", "0", 0);
    } else if (!strcmp(enc->name, "libsvtav1")) {
        char sp[8];
        snprintf(sp, sizeof sp, "%d", speed < 0 ? 8 : speed);
        av_opt_set(e->ctx->priv_data, "preset", sp, 0);
        /* low-delay pred structure, no lookahead: packets come back in
         * presentation order with no delay, matching the muxer's
         * arrival-order CMAF packaging (same contract lag-in-frames=0
         * gives libaom above). */
        av_opt_set(e->ctx->priv_data, "svtav1-params",
                   "pred-struct=1:lookahead=0", 0);
    } else if (!strcmp(enc->name, "librav1e")) {
        av_opt_set(e->ctx->priv_data, "rav1e-params",
                   "low_latency=true", 0);
    }
    if (avcodec_open2(e->ctx, enc, NULL) < 0) {
        avcodec_free_context(&e->ctx);
        free(e);
        return NULL;
    }
    e->frame = av_frame_alloc();
    e->pkt = av_packet_alloc();
    return e;
}

/* Submit one I420 frame; 0 on success. */
int vt_av1_send(void *h, const uint8_t *y, const uint8_t *u,
                const uint8_t *v, int force_key) {
    VtAv1Enc *e = h;
    AVFrame *f = e->frame;
    f->format = AV_PIX_FMT_YUV420P;
    f->width = e->w;
    f->height = e->h;
    if (av_frame_get_buffer(f, 0) < 0) return -1;
    if (av_frame_make_writable(f) < 0) return -2;
    av_image_copy_plane(f->data[0], f->linesize[0], y, e->w, e->w, e->h);
    av_image_copy_plane(f->data[1], f->linesize[1], u, e->w / 2,
                        e->w / 2, e->h / 2);
    av_image_copy_plane(f->data[2], f->linesize[2], v, e->w / 2,
                        e->w / 2, e->h / 2);
    f->pts = e->next_pts++;
    f->pict_type = force_key ? AV_PICTURE_TYPE_I : AV_PICTURE_TYPE_NONE;
    int rc = avcodec_send_frame(e->ctx, f);
    av_frame_unref(f);
    return rc < 0 ? -3 : 0;
}

int vt_av1_flush(void *h) {
    VtAv1Enc *e = h;
    if (e->flushed) return 0;
    e->flushed = 1;
    return avcodec_send_frame(e->ctx, NULL) < 0 ? -1 : 0;
}

/* Drain one packet: >0 = bytes written (is_key/pts filled), 0 = encoder
 * needs more input, -1 = end of stream, -2 = output buffer too small
 * (the packet is HELD and re-delivered on the next call with a larger
 * buffer — never dropped), -3 = encoder error. */
int64_t vt_av1_receive(void *h, uint8_t *out, int64_t cap, int *is_key,
                       int64_t *pts) {
    VtAv1Enc *e = h;
    if (!e->held) {
        int rc = avcodec_receive_packet(e->ctx, e->pkt);
        if (rc == AVERROR(EAGAIN)) return 0;
        if (rc == AVERROR_EOF) return -1;
        if (rc < 0) return -3;
    }
    if (e->pkt->size > cap) {
        e->held = 1;
        return -2;
    }
    e->held = 0;
    memcpy(out, e->pkt->data, e->pkt->size);
    if (is_key) *is_key = (e->pkt->flags & AV_PKT_FLAG_KEY) != 0;
    if (pts) *pts = e->pkt->pts;
    int64_t n = e->pkt->size;
    av_packet_unref(e->pkt);
    return n;
}

void vt_av1_close(void *h) {
    VtAv1Enc *e = h;
    if (!e) return;
    if (e->ctx) avcodec_free_context(&e->ctx);
    if (e->frame) av_frame_free(&e->frame);
    if (e->pkt) av_packet_free(&e->pkt);
    free(e);
}
