/* oracle.c -- encoder and golden decoder of the benchmark's corpus.
 *
 * A copy of the repository's fixture oracle (tools/oracle/oracle.c), kept
 * beside the corpus so that the yardstick does not move with the tools.
 * It uses the system libavcodec, which wraps libvpx for encoding and
 * ships a spec-exact native VP9 decoder, to
 *   1) encode raw I420 video into VP9-in-IVF streams, and
 *   2) decode VP9 IVF streams to per-frame MD5s in the format of the
 *      reference's decode_to_md5 example.
 *
 * Usage:
 *   oracle encode <w> <h> <in.yuv> <out.ivf> [key=val ...]
 *       keys: fps (30) crf (32; -1 leaves it unset: bitrate mode)
 *             bitrate (0) minrate (0) maxrate (0) gop (9999) lossless (0)
 *             tile_cols (0 = log2) cpu_used (1) cpu_used_pass1 (-1:
 *             cpu_used; the first of two passes) bitdepth (8|10|12)
 *             profile (0-3) pixfmt (420|422|444) aq_mode threads lag
 *             auto_alt_ref frame_parallel error_resilient
 *             passes (1, or 2: a first pass for statistics, then the
 *             encode)
 *   oracle decode <in.ivf> <out.md5> [raw_out.yuv] [codec=vp9|libvpx-vp9]
 */
#include <libavcodec/avcodec.h>
#include <libavutil/pixdesc.h>
#include <libavutil/opt.h>
#include <libavutil/imgutils.h>
#include <libavutil/md5.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static void die(const char *msg) { fprintf(stderr, "oracle: %s\n", msg); exit(1); }

/* ---------------- IVF ---------------- */
static void w16(FILE *f, unsigned v) { fputc(v & 255, f); fputc((v >> 8) & 255, f); }
static void w32(FILE *f, unsigned v) { w16(f, v & 0xffff); w16(f, v >> 16); }
static void w64(FILE *f, uint64_t v) { w32(f, (unsigned)(v & 0xffffffffu)); w32(f, (unsigned)(v >> 32)); }

static unsigned r16(FILE *f) { int a = fgetc(f), b = fgetc(f); return (unsigned)a | ((unsigned)b << 8); }
static unsigned r32(FILE *f) { unsigned a = r16(f), b = r16(f); return a | (b << 16); }

static void ivf_write_header2(FILE *f, const char *fourcc, int w, int h,
                              int fps, unsigned count) {
    fseek(f, 0, SEEK_SET);
    fwrite("DKIF", 1, 4, f); w16(f, 0); w16(f, 32);
    fwrite(fourcc, 1, 4, f); w16(f, w); w16(f, h);
    w32(f, fps); w32(f, 1); w32(f, count); w32(f, 0);
}

/* ---------------- encode ---------------- */
struct enc_opts {
    int w, h, fps, crf, bitrate, minrate, maxrate, gop, lossless;
    int tile_cols, tile_rows, cpu_used, bitdepth, profile, aq_mode, threads;
    int lag, auto_alt_ref, frame_parallel, error_resilient, ss, passes;
    int cpu_used_pass1;
    const char *enc_name, *in_path, *out_path;
};

/* One pass over the input: pass 0 is a single-pass encode, pass 1 the
 * first of two (its statistics returned in *stats, no packet written),
 * pass 2 the second (reading *stats). */
static void encode_pass(const struct enc_opts *o, int pass, char **stats) {
    int w = o->w, h = o->h, bitdepth = o->bitdepth, ss = o->ss;
    int is_vp8 = !strcmp(o->enc_name, "libvpx");
    const AVCodec *codec = avcodec_find_encoder_by_name(o->enc_name);
    if (!codec) die("encoder not found");
    AVCodecContext *c = avcodec_alloc_context3(codec);
    c->width = w; c->height = h;
    c->time_base = (AVRational){1, o->fps};
    c->framerate = (AVRational){o->fps, 1};
    c->pix_fmt =
        ss == 422 ? (bitdepth == 12 ? AV_PIX_FMT_YUV422P12LE
                   : bitdepth == 10 ? AV_PIX_FMT_YUV422P10LE
                                    : AV_PIX_FMT_YUV422P)
      : ss == 444 ? (bitdepth == 12 ? AV_PIX_FMT_YUV444P12LE
                   : bitdepth == 10 ? AV_PIX_FMT_YUV444P10LE
                                    : AV_PIX_FMT_YUV444P)
                  : (bitdepth == 12 ? AV_PIX_FMT_YUV420P12LE
                   : bitdepth == 10 ? AV_PIX_FMT_YUV420P10LE
                                    : AV_PIX_FMT_YUV420P);
    c->gop_size = o->gop;
    c->max_b_frames = 0;
    c->thread_count = o->threads;
    c->profile = o->profile;
    if (o->bitrate > 0) c->bit_rate = o->bitrate;
    if (o->minrate > 0) c->rc_min_rate = o->minrate;
    if (o->maxrate > 0) c->rc_max_rate = o->maxrate;
    if (pass == 1) c->flags |= AV_CODEC_FLAG_PASS1;
    if (pass == 2) {
        c->flags |= AV_CODEC_FLAG_PASS2;
        c->stats_in = av_strdup(*stats);
    }
    char buf[32];
    if (o->crf >= 0) {
        snprintf(buf, sizeof buf, "%d", o->crf);
        av_opt_set(c->priv_data, "crf", buf, 0);
    }
    if (o->bitrate == 0) c->bit_rate = 0; /* CQ mode */
    snprintf(buf, sizeof buf, "%d", pass == 1 && o->cpu_used_pass1 >= 0
             ? o->cpu_used_pass1 : o->cpu_used);
    av_opt_set(c->priv_data, "cpu-used", buf, 0);
    if (!is_vp8) {
        snprintf(buf, sizeof buf, "%d", o->lossless);
        av_opt_set(c->priv_data, "lossless", buf, 0);
        snprintf(buf, sizeof buf, "%d", o->tile_cols);
        av_opt_set(c->priv_data, "tile-columns", buf, 0);
        snprintf(buf, sizeof buf, "%d", o->tile_rows);
        av_opt_set(c->priv_data, "tile-rows", buf, 0);
        snprintf(buf, sizeof buf, "%d", o->aq_mode);
        av_opt_set(c->priv_data, "aq-mode", buf, 0);
        snprintf(buf, sizeof buf, "%d", o->frame_parallel);
        av_opt_set(c->priv_data, "frame-parallel", buf, 0);
    }
    snprintf(buf, sizeof buf, "%d", o->lag);
    av_opt_set(c->priv_data, "lag-in-frames", buf, 0);
    if (o->error_resilient)
        av_opt_set(c->priv_data, "error-resilient", "default", 0);
    snprintf(buf, sizeof buf, "%d", o->auto_alt_ref);
    av_opt_set(c->priv_data, "auto-alt-ref", buf, 0);
    if (avcodec_open2(c, codec, NULL) < 0) die("encoder open failed");

    FILE *fin = fopen(o->in_path, "rb");
    if (!fin) die("cannot open input yuv");
    FILE *fout = NULL;
    if (pass != 1) {
        fout = fopen(o->out_path, "wb");
        if (!fout) die("cannot open output ivf");
        ivf_write_header2(fout, is_vp8 ? "VP80" : "VP90", w, h, o->fps, 0);
    }

    AVFrame *frame = av_frame_alloc();
    frame->format = c->pix_fmt; frame->width = w; frame->height = h;
    av_frame_get_buffer(frame, 0);
    AVPacket *pkt = av_packet_alloc();
    int bytes_per = bitdepth > 8 ? 2 : 1;
    int cw_full = ss == 444 ? w : (w + 1) / 2;
    int ch_full = ss == 420 ? (h + 1) / 2 : h;
    size_t ysz = (size_t)w * h * bytes_per;
    size_t csz = (size_t)cw_full * ch_full * bytes_per;
    uint8_t *ybuf = malloc(ysz), *ubuf = malloc(csz), *vbuf = malloc(csz);
    unsigned nout = 0;
    int64_t pts = 0;
    for (;;) {
        int got = fread(ybuf, 1, ysz, fin) == ysz &&
                  fread(ubuf, 1, csz, fin) == csz &&
                  fread(vbuf, 1, csz, fin) == csz;
        if (got) {
            av_frame_make_writable(frame);
            for (int r = 0; r < h; r++)
                memcpy(frame->data[0] + r * frame->linesize[0], ybuf + (size_t)r * w * bytes_per, (size_t)w * bytes_per);
            int cw = cw_full, ch = ch_full;
            for (int r = 0; r < ch; r++) {
                memcpy(frame->data[1] + r * frame->linesize[1], ubuf + (size_t)r * cw * bytes_per, (size_t)cw * bytes_per);
                memcpy(frame->data[2] + r * frame->linesize[2], vbuf + (size_t)r * cw * bytes_per, (size_t)cw * bytes_per);
            }
            frame->pts = pts++;
        }
        int ret = avcodec_send_frame(c, got ? frame : NULL);
        if (ret < 0) die("send_frame failed");
        for (;;) {
            ret = avcodec_receive_packet(c, pkt);
            if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
            if (ret < 0) die("receive_packet failed");
            if (fout) {
                w32(fout, pkt->size); w64(fout, (uint64_t)pkt->pts);
                fwrite(pkt->data, 1, pkt->size, fout);
            }
            nout++;
            av_packet_unref(pkt);
        }
        if (!got) break;
    }
    if (pass == 1) {
        if (!c->stats_out) die("first pass left no statistics");
        *stats = strdup(c->stats_out);
    }
    if (fout) {
        ivf_write_header2(fout, is_vp8 ? "VP80" : "VP90", w, h, o->fps, nout);
        fclose(fout);
    }
    fclose(fin);
    free(ybuf); free(ubuf); free(vbuf);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&c);
    fprintf(stderr, "pass %d: %u packets\n", pass, nout);
}

/* ---------------- encode ---------------- */
static int do_encode(int argc, char **argv) {
    if (argc < 4) die("encode needs <w> <h> <in.yuv> <out.ivf>");
    struct enc_opts o = {
        .w = atoi(argv[0]), .h = atoi(argv[1]), .fps = 30, .crf = 32,
        .gop = 9999, .cpu_used = 1, .bitdepth = 8, .threads = 1, .ss = 420,
        .passes = 1, .cpu_used_pass1 = -1,
        .enc_name = "libvpx-vp9", /* codec=libvpx: VP8 */
        .in_path = argv[2], .out_path = argv[3]};
    for (int i = 4; i < argc; i++) {
        char key[64]; int val;
        char sval[64];
        if (sscanf(argv[i], "codec=%63s", sval) == 1) {
            o.enc_name = strdup(sval); continue;
        }
        if (sscanf(argv[i], "%63[^=]=%d", key, &val) != 2) die("bad key=val");
        if (!strcmp(key, "fps")) o.fps = val;
        else if (!strcmp(key, "pixfmt")) o.ss = val;
        else if (!strcmp(key, "crf")) o.crf = val;
        else if (!strcmp(key, "bitrate")) o.bitrate = val;
        else if (!strcmp(key, "minrate")) o.minrate = val;
        else if (!strcmp(key, "maxrate")) o.maxrate = val;
        else if (!strcmp(key, "gop")) o.gop = val;
        else if (!strcmp(key, "lossless")) o.lossless = val;
        else if (!strcmp(key, "tile_cols")) o.tile_cols = val;
        else if (!strcmp(key, "tile_rows")) o.tile_rows = val;
        else if (!strcmp(key, "cpu_used")) o.cpu_used = val;
        else if (!strcmp(key, "cpu_used_pass1")) o.cpu_used_pass1 = val;
        else if (!strcmp(key, "bitdepth")) o.bitdepth = val;
        else if (!strcmp(key, "profile")) o.profile = val;
        else if (!strcmp(key, "aq_mode")) o.aq_mode = val;
        else if (!strcmp(key, "threads")) o.threads = val;
        else if (!strcmp(key, "lag")) o.lag = val;
        else if (!strcmp(key, "auto_alt_ref")) o.auto_alt_ref = val;
        else if (!strcmp(key, "frame_parallel")) o.frame_parallel = val;
        else if (!strcmp(key, "error_resilient")) o.error_resilient = val;
        else if (!strcmp(key, "passes")) o.passes = val;
        else die("unknown key");
    }
    if (o.passes == 2) {
        char *stats = NULL;
        encode_pass(&o, 1, &stats);
        encode_pass(&o, 2, &stats);
        free(stats);
    } else {
        encode_pass(&o, 0, NULL);
    }
    return 0;
}

/* ---------------- decode ---------------- */
static int do_decode(int argc, char **argv) {
    if (argc < 2) die("decode needs <in.ivf> <out.md5> [raw.yuv] [codec=...]");
    const char *in_path = argv[0], *md5_path = argv[1];
    const char *raw_path = NULL, *codec_name = "vp9";
    int skip_lf = 0;
    for (int i = 2; i < argc; i++) {
        if (!strncmp(argv[i], "codec=", 6)) codec_name = argv[i] + 6;
        else if (!strcmp(argv[i], "nolf")) skip_lf = 1;
        else raw_path = argv[i];
    }
    FILE *fin = fopen(in_path, "rb");
    if (!fin) die("cannot open ivf");
    char sig[4];
    if (fread(sig, 1, 4, fin) != 4 || memcmp(sig, "DKIF", 4)) die("not IVF");
    r16(fin); unsigned hdr_sz = r16(fin);
    char fourcc[5] = {0}; fread(fourcc, 1, 4, fin);
    unsigned w = r16(fin), h = r16(fin);
    r32(fin); r32(fin); r32(fin); r32(fin);
    fseek(fin, hdr_sz, SEEK_SET);

    const AVCodec *codec = avcodec_find_decoder_by_name(codec_name);
    if (!codec) die("decoder not found");
    AVCodecContext *c = avcodec_alloc_context3(codec);
    if (skip_lf) c->skip_loop_filter = AVDISCARD_ALL;
    if (avcodec_open2(c, codec, NULL) < 0) die("decoder open failed");

    FILE *fmd5 = fopen(md5_path, "wb");
    if (!fmd5) die("cannot open md5 out");
    FILE *fraw = raw_path ? fopen(raw_path, "wb") : NULL;

    AVPacket *pkt = av_packet_alloc();
    AVFrame *frame = av_frame_alloc();
    unsigned idx = 0;
    int eof = 0;
    while (!eof) {
        unsigned size = r32(fin);
        if (feof(fin)) { eof = 1; av_packet_unref(pkt); pkt->data = NULL; pkt->size = 0; }
        else {
            r32(fin); r32(fin); /* pts */
            av_new_packet(pkt, size);
            if (fread(pkt->data, 1, size, fin) != size) die("truncated frame");
        }
        int ret = avcodec_send_packet(c, eof ? NULL : pkt);
        if (ret < 0) die("send_packet failed");
        if (!eof) av_packet_unref(pkt);
        for (;;) {
            ret = avcodec_receive_frame(c, frame);
            if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
            if (ret < 0) die("receive_frame failed");
            int fw = frame->width, fh = frame->height;
            const AVPixFmtDescriptor *pd = av_pix_fmt_desc_get(frame->format);
            int bp = pd->comp[0].depth > 8 ? 2 : 1;
            struct AVMD5 *md5 = av_md5_alloc();
            av_md5_init(md5);
            for (int plane = 0; plane < 3; plane++) {
                int pw = plane ? ((fw + (1 << pd->log2_chroma_w) - 1)
                                  >> pd->log2_chroma_w) : fw;
                int ph = plane ? ((fh + (1 << pd->log2_chroma_h) - 1)
                                  >> pd->log2_chroma_h) : fh;
                for (int r = 0; r < ph; r++) {
                    av_md5_update(md5, frame->data[plane] + (size_t)r * frame->linesize[plane], (size_t)pw * bp);
                    if (fraw) fwrite(frame->data[plane] + (size_t)r * frame->linesize[plane], 1, (size_t)pw * bp, fraw);
                }
            }
            uint8_t digest[16];
            av_md5_final(md5, digest);
            av_free(md5);
            for (int i = 0; i < 16; i++) fprintf(fmd5, "%02x", digest[i]);
            fprintf(fmd5, "  img-%dx%d-%04u.i420\n", fw, fh, ++idx);
            av_frame_unref(frame);
        }
    }
    fclose(fmd5);
    if (fraw) fclose(fraw);
    fprintf(stderr, "decoded %u frames (%s %ux%u, codec=%s)\n", idx, fourcc, w, h, codec_name);
    return 0;
}

int main(int argc, char **argv) {
    if (argc < 2) die("usage: oracle encode|decode ...");
    if (!strcmp(argv[1], "encode")) return do_encode(argc - 2, argv + 2);
    if (!strcmp(argv[1], "decode")) return do_decode(argc - 2, argv + 2);
    die("unknown subcommand");
    return 1;
}
