// Compressed-audio decode (FLAC / MP3 / OGG / M4A / anything libav knows)
// plus a small encode helper used by the round-trip tests, C ABI.
//
// Capability parity target: the reference loads clips with torchaudio.load
// (reference WavLM_embeddings.py:101), whose backend is this same ffmpeg —
// so any format a reference user's corpus contains must decode here too.
// wavio.cpp's dependency-free RIFF parser stays the primary path for .wav;
// this library registers itself as its fallback decoder (see
// wavio_set_fallback_decoder), which makes the threaded batch decoder and
// every Python entry point format-agnostic without new plumbing.
//
// Design notes:
// - Output is mono float32 at the stream's native rate; multi-channel input
//   is mixed down as the per-frame MEAN over channels, matching both the
//   RIFF parser and the reference's `waveform.mean(dim=0)`.
// - Sample-format conversion is done manually for the formats real codecs
//   emit (u8/s16/s32/f32/f64, packed or planar) instead of pulling in
//   swresample — the mean mixdown must stay exact, and swresample's default
//   downmix matrix is not a plain mean.
// - Each call builds its own format/codec contexts, so concurrent calls from
//   wavio.cpp's decode thread pool are safe.
//
// The port's copy of stutter_tpu/audio/csrc/ffdecode.cpp, with the same C
// API and status codes. Built at first use by
// stutter_tpu_torch/audio/build.py with
//   g++ -O3 -shared -fPIC -std=c++17 -pthread ffdecode.cpp -lavformat -lavcodec -lavutil
// and left out (WAV-only mode) when no libav headers are installed.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
}

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Quiet libav's per-file warning chatter (e.g. "Could not update timestamps
// for skipped samples" on every MP3) — decode errors surface through return
// codes, and the pipeline logs skips itself.
struct QuietLogs {
    QuietLogs() { av_log_set_level(AV_LOG_ERROR); }
} quiet_logs_init;

int frame_channels(const AVFrame* f) {
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 24, 100)
    return f->ch_layout.nb_channels;
#else
    return f->channels;
#endif
}

// Channel setup across the ffmpeg 5.1 AVChannelLayout API break — same
// version gate as frame_channels so the extension still compiles against
// ffmpeg 4.x dev packages (e.g. Ubuntu 22.04).
void ctx_set_channels(AVCodecContext* ctx, int channels) {
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 24, 100)
    av_channel_layout_default(&ctx->ch_layout, channels);
#else
    ctx->channels = channels;
    ctx->channel_layout = av_get_default_channel_layout(channels);
#endif
}

void frame_copy_channels(AVFrame* frame, const AVCodecContext* ctx) {
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 24, 100)
    av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
#else
    frame->channels = ctx->channels;
    frame->channel_layout = ctx->channel_layout;
#endif
}

// Append one decoded frame to `mono` as the mean over channels.
// Returns false on an unsupported sample format.
bool append_frame_mono(std::vector<float>& mono, const AVFrame* f) {
    const int ch = frame_channels(f);
    const int n = f->nb_samples;
    if (ch <= 0 || n <= 0) return true;
    const double inv = 1.0 / ch;
    const AVSampleFormat fmt = (AVSampleFormat)f->format;
    const bool planar = av_sample_fmt_is_planar(fmt) != 0;

    // sample value for (frame i, channel c) in double
    auto sample = [&](int i, int c) -> double {
        const int plane = planar ? c : 0;
        const int idx = planar ? i : i * ch + c;
        const uint8_t* base = f->data[plane];
        switch (av_get_packed_sample_fmt(fmt)) {
            case AV_SAMPLE_FMT_U8:
                return ((double)((const uint8_t*)base)[idx] - 128.0) / 128.0;
            case AV_SAMPLE_FMT_S16:
                return (double)((const int16_t*)base)[idx] / 32768.0;
            case AV_SAMPLE_FMT_S32:
                return (double)((const int32_t*)base)[idx] / 2147483648.0;
            case AV_SAMPLE_FMT_FLT:
                return (double)((const float*)base)[idx];
            case AV_SAMPLE_FMT_DBL:
                return ((const double*)base)[idx];
            default:
                return 0.0;
        }
    };

    switch (av_get_packed_sample_fmt(fmt)) {
        case AV_SAMPLE_FMT_U8:
        case AV_SAMPLE_FMT_S16:
        case AV_SAMPLE_FMT_S32:
        case AV_SAMPLE_FMT_FLT:
        case AV_SAMPLE_FMT_DBL:
            break;
        default:
            return false;  // S64 etc. — no real audio codec emits these
    }

    size_t base = mono.size();
    mono.resize(base + (size_t)n);
    for (int i = 0; i < n; i++) {
        double acc = 0.0;
        for (int c = 0; c < ch; c++) acc += sample(i, c);
        mono[base + (size_t)i] = (float)(acc * inv);
    }
    return true;
}

}  // namespace

extern "C" {

// Decode any libav-supported audio file to mono float32 at native rate.
// Same contract as wavio_decode: 0 on success, caller frees *out with
// wavio_free/free. Nonzero codes identify the failing stage (logged debug-
// level by the Python wrapper; per-file skip is the pipeline contract).
int ffdecode_decode(const char* path, float** out, int64_t* n_samples,
                    int32_t* sample_rate) {
    *out = nullptr;
    *n_samples = 0;
    *sample_rate = 0;

    AVFormatContext* ic = nullptr;
    if (avformat_open_input(&ic, path, nullptr, nullptr) < 0) return 1;

    int rc = 0;
    AVCodecContext* ctx = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    std::vector<float> mono;
    int stream_index = -1;

    do {
        if (avformat_find_stream_info(ic, nullptr) < 0) { rc = 2; break; }
        stream_index = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
        if (stream_index < 0) { rc = 3; break; }
        AVStream* st = ic->streams[stream_index];
        const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
        if (!dec) { rc = 4; break; }
        ctx = avcodec_alloc_context3(dec);
        if (!ctx || avcodec_parameters_to_context(ctx, st->codecpar) < 0) { rc = 5; break; }
        if (avcodec_open2(ctx, dec, nullptr) < 0) { rc = 5; break; }

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        if (!pkt || !frame) { rc = 6; break; }

        auto drain = [&]() -> int {
            while (true) {
                int r = avcodec_receive_frame(ctx, frame);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
                if (r < 0) return 7;
                if (!append_frame_mono(mono, frame)) return 8;
                av_frame_unref(frame);
            }
        };

        while (rc == 0 && av_read_frame(ic, pkt) >= 0) {
            if (pkt->stream_index == stream_index &&
                avcodec_send_packet(ctx, pkt) >= 0) {
                rc = drain();
            }
            av_packet_unref(pkt);
        }
        if (rc == 0) {
            avcodec_send_packet(ctx, nullptr);  // flush
            rc = drain();
        }
        if (rc == 0 && mono.empty()) rc = 9;
        if (rc == 0 && ctx->sample_rate <= 0) rc = 9;
    } while (false);

    if (rc == 0) {
        float* buf = (float*)malloc(sizeof(float) * mono.size());
        if (!buf) {
            rc = 6;
        } else {
            memcpy(buf, mono.data(), sizeof(float) * mono.size());
            *out = buf;
            *n_samples = (int64_t)mono.size();
            *sample_rate = ctx->sample_rate;
        }
    }

    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    avformat_close_input(&ic);
    return rc;
}

void ffdecode_free(float* p) { free(p); }

// Header-only probe: sample count + rate without decoding (bucket planning /
// long-file detection need durations for thousands of files cheaply; FLAC
// STREAMINFO and MP3 Xing headers make this exact for real encoders).
int ffdecode_probe(const char* path, int64_t* n_samples, int32_t* sample_rate) {
    *n_samples = 0;
    *sample_rate = 0;
    AVFormatContext* ic = nullptr;
    if (avformat_open_input(&ic, path, nullptr, nullptr) < 0) return 1;
    int rc = 0;
    do {
        if (avformat_find_stream_info(ic, nullptr) < 0) { rc = 2; break; }
        int si = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
        if (si < 0) { rc = 3; break; }
        AVStream* st = ic->streams[si];
        const int sr = st->codecpar->sample_rate;
        if (sr <= 0) { rc = 4; break; }
        int64_t n;
        if (st->duration != AV_NOPTS_VALUE && st->duration > 0) {
            n = av_rescale_q(st->duration, st->time_base, AVRational{1, sr});
        } else if (ic->duration != AV_NOPTS_VALUE && ic->duration > 0) {
            n = av_rescale(ic->duration, sr, AV_TIME_BASE);
        } else {
            rc = 5;
            break;
        }
        *n_samples = n;
        *sample_rate = sr;
    } while (false);
    avformat_close_input(&ic);
    return rc;
}

// ---------------------------------------------------------------------------
// Encode helper (tests + fixture generation; not on any hot path)
// ---------------------------------------------------------------------------

namespace {

// Fill one AVFrame's sample buffers from interleaved float32 input.
bool fill_frame(AVFrame* f, const float* pcm, int64_t offset, int n, int ch) {
    const AVSampleFormat fmt = (AVSampleFormat)f->format;
    const bool planar = av_sample_fmt_is_planar(fmt) != 0;
    for (int c = 0; c < ch; c++) {
        uint8_t* base = f->data[planar ? c : 0];
        for (int i = 0; i < n; i++) {
            const float v0 = pcm[(offset + i) * ch + c];
            const float v = v0 < -1.0f ? -1.0f : (v0 > 1.0f ? 1.0f : v0);
            const int idx = planar ? i : i * ch + c;
            switch (av_get_packed_sample_fmt(fmt)) {
                case AV_SAMPLE_FMT_S16:
                    ((int16_t*)base)[idx] = (int16_t)lrintf(v * 32767.0f);
                    break;
                case AV_SAMPLE_FMT_S32:
                    ((int32_t*)base)[idx] = (int32_t)lrint((double)v * 2147483647.0);
                    break;
                case AV_SAMPLE_FMT_FLT:
                    ((float*)base)[idx] = v;
                    break;
                case AV_SAMPLE_FMT_DBL:
                    ((double*)base)[idx] = (double)v;
                    break;
                default:
                    return false;
            }
        }
    }
    return true;
}

int send_and_mux(AVFormatContext* oc, AVCodecContext* ctx, AVStream* st,
                 AVFrame* frame, AVPacket* pkt) {
    if (avcodec_send_frame(ctx, frame) < 0) return 1;
    while (true) {
        int r = avcodec_receive_packet(ctx, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
        if (r < 0) return 1;
        av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(oc, pkt) < 0) return 1;
    }
}

}  // namespace

// Encode interleaved float32 PCM to `path`; the container/codec is chosen
// from the file extension (.flac / .mp3 / .ogg / ...). Returns 0 on success.
// Used by tests to build compressed fixtures in-process (no ffmpeg CLI in
// this environment) — which also means decode is exercised against a real
// encoder's output rather than hand-rolled bitstreams.
int ffdecode_encode(const char* path, const float* pcm, int64_t n_frames,
                    int32_t sample_rate, int32_t channels) {
    if (n_frames <= 0 || channels <= 0 || sample_rate <= 0) return 1;

    AVFormatContext* oc = nullptr;
    if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path) < 0 || !oc)
        return 2;

    int rc = 0;
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    bool io_open = false;

    do {
        AVCodecID want = oc->oformat->audio_codec;
        if (want == AV_CODEC_ID_NONE) { rc = 3; break; }
        const AVCodec* enc = nullptr;
        // Prefer the external encoders for codecs whose native ffmpeg
        // implementations are experimental (vorbis) or absent (mp3).
        if (want == AV_CODEC_ID_VORBIS) enc = avcodec_find_encoder_by_name("libvorbis");
        if (want == AV_CODEC_ID_MP3) enc = avcodec_find_encoder_by_name("libmp3lame");
        if (!enc) enc = avcodec_find_encoder(want);
        if (!enc) { rc = 3; break; }

        AVStream* st = avformat_new_stream(oc, nullptr);
        ctx = avcodec_alloc_context3(enc);
        if (!st || !ctx) { rc = 4; break; }

        ctx->sample_rate = sample_rate;
        ctx_set_channels(ctx, channels);
        ctx->sample_fmt = enc->sample_fmts ? enc->sample_fmts[0] : AV_SAMPLE_FMT_S16;
        // FLAC: force s16 so the round trip is exactly the int16 lattice
        if (want == AV_CODEC_ID_FLAC) ctx->sample_fmt = AV_SAMPLE_FMT_S16;
        ctx->time_base = AVRational{1, sample_rate};
        if (oc->oformat->flags & AVFMT_GLOBALHEADER)
            ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        // native vorbis (if libvorbis is ever absent) needs the opt-in
        ctx->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;

        if (avcodec_open2(ctx, enc, nullptr) < 0) { rc = 5; break; }
        if (avcodec_parameters_from_context(st->codecpar, ctx) < 0) { rc = 5; break; }
        st->time_base = ctx->time_base;

        if (!(oc->oformat->flags & AVFMT_NOFILE)) {
            if (avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0) { rc = 6; break; }
            io_open = true;
        }
        if (avformat_write_header(oc, nullptr) < 0) { rc = 6; break; }

        const int chunk = ctx->frame_size > 0 ? ctx->frame_size : 4096;
        frame = av_frame_alloc();
        pkt = av_packet_alloc();
        if (!frame || !pkt) { rc = 4; break; }

        int64_t pos = 0;
        while (pos < n_frames && rc == 0) {
            const int n = (int)((n_frames - pos) < chunk ? (n_frames - pos) : chunk);
            frame->nb_samples = n;
            frame->format = ctx->sample_fmt;
            frame->sample_rate = sample_rate;
            frame_copy_channels(frame, ctx);
            if (av_frame_get_buffer(frame, 0) < 0) { rc = 7; break; }
            if (!fill_frame(frame, pcm, pos, n, channels)) { rc = 8; break; }
            frame->pts = pos;
            rc = send_and_mux(oc, ctx, st, frame, pkt) ? 9 : 0;
            av_frame_unref(frame);
            pos += n;
        }
        if (rc == 0) rc = send_and_mux(oc, ctx, st, nullptr, pkt) ? 9 : 0;  // flush
        if (rc == 0 && av_write_trailer(oc) < 0) rc = 10;
    } while (false);

    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (io_open) avio_closep(&oc->pb);
    avformat_free_context(oc);
    return rc;
}

}  // extern "C"
