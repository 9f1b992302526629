/* Foreign-upload ingest shim over the system libavformat/libavcodec.
 *
 * The reference ingests "anything ffmpeg decodes" by shelling out
 * (worker/transcoder.py:706-758, 1006). This framework's first-party
 * decoder covers its own I/P CAVLC envelope; for everything else —
 * x264/CABAC/B-frame H.264, HEVC, VP9, MKV/MOV/WebM containers — this
 * shim decodes through the same system libraries the reference's ffmpeg
 * build used, delivering I420 frames into caller buffers. The ENCODE
 * path stays first-party; this is ingest only, exactly the boundary the
 * reference drew.
 *
 * A verbatim copy of the JAX package's vlog_tpu/native/avshim.c. Built
 * on demand by vlog_tpu_torch/native/build.py (get_av_lib) when the
 * libavformat headers are present; without it the port keeps its
 * first-party decode envelope and foreign uploads are rejected.
 */

#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libswscale/swscale.h>
#include <libavutil/imgutils.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext *vctx;
    AVPacket *pkt;
    AVFrame *frame;
    struct SwsContext *sws;
    int vidx;
    int w, h;
    int eof;
    int64_t next_index;     /* display index of the next frame returned */
} VtAv;

typedef struct {
    int width, height;
    double fps;
    double duration;        /* seconds, container-level */
    int64_t nb_frames;      /* container hint; -1 unknown */
    int has_audio;
    char vcodec[32];
    char acodec[32];
} VtAvInfo;

static int open_video(VtAv *av, const char *path) {
    if (avformat_open_input(&av->fmt, path, NULL, NULL) < 0) return -1;
    if (avformat_find_stream_info(av->fmt, NULL) < 0) return -2;
    av->vidx = av_find_best_stream(av->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                   NULL, 0);
    if (av->vidx < 0) return -3;
    AVStream *st = av->fmt->streams[av->vidx];
    const AVCodec *dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) return -4;
    av->vctx = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(av->vctx, st->codecpar);
    if (avcodec_open2(av->vctx, dec, NULL) < 0) return -5;
    av->pkt = av_packet_alloc();
    av->frame = av_frame_alloc();
    av->w = st->codecpar->width;
    av->h = st->codecpar->height;
    return 0;
}

void *vt_av_open(const char *path, VtAvInfo *info) {
    VtAv *av = (VtAv *)calloc(1, sizeof(VtAv));
    if (open_video(av, path) != 0) {
        if (av->fmt) avformat_close_input(&av->fmt);
        free(av);
        return NULL;
    }
    AVStream *st = av->fmt->streams[av->vidx];
    memset(info, 0, sizeof(*info));
    info->width = av->w;
    info->height = av->h;
    AVRational fr = av_guess_frame_rate(av->fmt, st, NULL);
    info->fps = fr.num > 0 && fr.den > 0 ? (double)fr.num / fr.den : 0.0;
    info->duration = av->fmt->duration != AV_NOPTS_VALUE
        ? (double)av->fmt->duration / AV_TIME_BASE : 0.0;
    info->nb_frames = st->nb_frames > 0 ? st->nb_frames : -1;
    info->has_audio = av_find_best_stream(av->fmt, AVMEDIA_TYPE_AUDIO,
                                          -1, -1, NULL, 0) >= 0;
    const char *vn = avcodec_get_name(st->codecpar->codec_id);
    strncpy(info->vcodec, vn ? vn : "?", sizeof(info->vcodec) - 1);
    int aidx = av_find_best_stream(av->fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                   NULL, 0);
    if (aidx >= 0) {
        const char *an = avcodec_get_name(
            av->fmt->streams[aidx]->codecpar->codec_id);
        strncpy(info->acodec, an ? an : "?", sizeof(info->acodec) - 1);
    }
    return av;
}

static void emit_i420(VtAv *av, AVFrame *f, uint8_t *dst) {
    int w = av->w, h = av->h;
    uint8_t *planes[3] = {dst, dst + (size_t)w * h,
                          dst + (size_t)w * h + (size_t)(w / 2) * (h / 2)};
    int strides[3] = {w, w / 2, w / 2};
    if (f->format == AV_PIX_FMT_YUV420P || f->format == AV_PIX_FMT_YUVJ420P) {
        for (int p = 0; p < 3; p++) {
            int ph = p ? h / 2 : h, pw = p ? w / 2 : w;
            for (int y = 0; y < ph; y++)
                memcpy(planes[p] + (size_t)y * pw,
                       f->data[p] + (size_t)y * f->linesize[p], pw);
        }
        return;
    }
    if (!av->sws)
        av->sws = sws_getContext(w, h, (enum AVPixelFormat)f->format,
                                 w, h, AV_PIX_FMT_YUV420P,
                                 SWS_BILINEAR, NULL, NULL, NULL);
    sws_scale(av->sws, (const uint8_t *const *)f->data, f->linesize,
              0, h, planes, strides);
}

/* Decode up to max_frames into buf (packed I420 per frame), with each
 * frame's presentation time (seconds; NAN-free, -1 when unknown) in
 * pts_out when non-NULL. Returns frames written; 0 at EOF; <0 on error. */
int64_t vt_av_read_pts(void *handle, uint8_t *buf, double *pts_out,
                       int64_t max_frames) {
    VtAv *av = (VtAv *)handle;
    size_t fsz = (size_t)av->w * av->h * 3 / 2;
    AVRational tb = av->fmt->streams[av->vidx]->time_base;
    int64_t got = 0;
    while (got < max_frames) {
        int r = avcodec_receive_frame(av->vctx, av->frame);
        if (r == 0) {
            emit_i420(av, av->frame, buf + (size_t)got * fsz);
            if (pts_out) {
                int64_t pts = av->frame->best_effort_timestamp;
                pts_out[got] = pts == AV_NOPTS_VALUE
                    ? -1.0 : pts * av_q2d(tb);
            }
            av_frame_unref(av->frame);
            got++;
            av->next_index++;
            continue;
        }
        if (r == AVERROR_EOF) break;
        if (r != AVERROR(EAGAIN)) return -1;
        if (av->eof) {
            if (avcodec_send_packet(av->vctx, NULL) < 0) break;
            continue;
        }
        int rr = av_read_frame(av->fmt, av->pkt);
        if (rr < 0) {
            av->eof = 1;
            avcodec_send_packet(av->vctx, NULL);
            continue;
        }
        if (av->pkt->stream_index == av->vidx)
            avcodec_send_packet(av->vctx, av->pkt);
        av_packet_unref(av->pkt);
    }
    return got;
}

int64_t vt_av_read(void *handle, uint8_t *buf, int64_t max_frames) {
    return vt_av_read_pts(handle, buf, NULL, max_frames);
}

/* Coarse seek for stride access (sprites): keyframe-accurate. Resets the
 * decoder; subsequent reads resume from the nearest prior keyframe. */
int vt_av_seek(void *handle, double seconds) {
    VtAv *av = (VtAv *)handle;
    int64_t ts = (int64_t)(seconds * AV_TIME_BASE);
    if (av_seek_frame(av->fmt, -1, ts, AVSEEK_FLAG_BACKWARD) < 0) return -1;
    avcodec_flush_buffers(av->vctx);
    av->eof = 0;
    return 0;
}

void vt_av_close(void *handle) {
    VtAv *av = (VtAv *)handle;
    if (!av) return;
    if (av->sws) sws_freeContext(av->sws);
    if (av->frame) av_frame_free(&av->frame);
    if (av->pkt) av_packet_free(&av->pkt);
    if (av->vctx) avcodec_free_context(&av->vctx);
    if (av->fmt) avformat_close_input(&av->fmt);
    free(av);
}

/* One-shot audio decode to interleaved float32 stereo-or-mono PCM written
 * as a headerless .f32 file next to a small header the caller reads.
 * Returns sample_rate<<8 | channels on success (both bounded), <0 on
 * error/no-audio. Caller passes the output path. */
int64_t vt_av_audio_to_f32(const char *path, const char *out_path) {
    AVFormatContext *fmt = NULL;
    if (avformat_open_input(&fmt, path, NULL, NULL) < 0) return -1;
    if (avformat_find_stream_info(fmt, NULL) < 0) {
        avformat_close_input(&fmt);
        return -2;
    }
    int aidx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, NULL, 0);
    if (aidx < 0) { avformat_close_input(&fmt); return -3; }
    AVStream *st = fmt->streams[aidx];
    const AVCodec *dec = avcodec_find_decoder(st->codecpar->codec_id);
    AVCodecContext *ctx = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(ctx, st->codecpar);
    if (!dec || avcodec_open2(ctx, dec, NULL) < 0) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return -4;
    }
    FILE *out = fopen(out_path, "wb");
    if (!out) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return -5;
    }
    AVPacket *pkt = av_packet_alloc();
    AVFrame *frame = av_frame_alloc();
    int channels =
#if LIBAVCODEC_VERSION_MAJOR >= 59
        ctx->ch_layout.nb_channels;
#else
        ctx->channels;
#endif
    if (channels > 2) channels = 2;
    if (channels < 1) channels = 1;
    int rate = ctx->sample_rate;
    int err = 0, flushing = 0;
    while (!err) {
        int r = avcodec_receive_frame(ctx, frame);
        if (r == 0) {
            int n = frame->nb_samples;
            int fc =
#if LIBAVCODEC_VERSION_MAJOR >= 59
                frame->ch_layout.nb_channels;
#else
                frame->channels;
#endif
            for (int i = 0; i < n; i++) {
                for (int c = 0; c < channels; c++) {
                    int sc = c < fc ? c : fc - 1;
                    float v = 0.f;
                    switch (frame->format) {
                    case AV_SAMPLE_FMT_FLTP:
                        v = ((float *)frame->data[sc])[i]; break;
                    case AV_SAMPLE_FMT_FLT:
                        v = ((float *)frame->data[0])[i * fc + sc]; break;
                    case AV_SAMPLE_FMT_S16P:
                        v = ((int16_t *)frame->data[sc])[i] / 32768.f; break;
                    case AV_SAMPLE_FMT_S16:
                        v = ((int16_t *)frame->data[0])[i * fc + sc] / 32768.f;
                        break;
                    case AV_SAMPLE_FMT_S32P:
                        v = ((int32_t *)frame->data[sc])[i] / 2147483648.f;
                        break;
                    case AV_SAMPLE_FMT_S32:
                        v = ((int32_t *)frame->data[0])[i * fc + sc]
                            / 2147483648.f;
                        break;
                    case AV_SAMPLE_FMT_DBLP:
                        v = (float)((double *)frame->data[sc])[i]; break;
                    default:
                        err = 1;
                    }
                    fwrite(&v, sizeof(float), 1, out);
                }
                if (err) break;
            }
            av_frame_unref(frame);
            continue;
        }
        if (r == AVERROR_EOF) break;
        if (r != AVERROR(EAGAIN)) { err = 1; break; }
        if (flushing) { avcodec_send_packet(ctx, NULL); continue; }
        int rr = av_read_frame(fmt, pkt);
        if (rr < 0) {
            flushing = 1;
            avcodec_send_packet(ctx, NULL);
            continue;
        }
        if (pkt->stream_index == aidx) avcodec_send_packet(ctx, pkt);
        av_packet_unref(pkt);
    }
    fclose(out);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    if (err) return -6;
    return ((int64_t)rate << 8) | (int64_t)channels;
}
