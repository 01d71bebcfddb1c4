// Host-side audio runtime: WAV decode + windowed-sinc resample, C ABI.
//
// The port's copy of stutter_tpu/audio/csrc/wavio.cpp, with the same C API
// and status codes. The reference loads audio with torchaudio.load +
// transforms.Resample (reference WavLM_embeddings.py:87-125); this is a
// dependency-free RIFF/WAVE parser (PCM u8/s16/s24/s32 and IEEE float32/64,
// any channel count -> mono float32), the polyphase windowed-sinc resampler
// of ops/resample.py (sinc_interp_hann, lowpass_filter_width=6,
// rolloff=0.99) accumulated in double (interior frames a tile at a time,
// each output summed in the reference's order), and a thread pool that
// decodes a whole batch so host decode keeps ahead of the device. Called
// through ctypes, which releases the GIL for the length of each call.
//
// Build: stutter_tpu_torch/audio/build.py compiles this with
// g++ -O3 -shared -fPIC -std=c++17 -pthread at first use and raises when
// the build fails (there is no numpy fallback on the main path).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <system_error>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Returns 0 on success. Caller frees *out with wavio_free.
// On success: *out = mono float32 samples, *n_samples, *sample_rate set.
static int wavio_decode_impl(const char* path, float** out, int64_t* n_samples,
                             int32_t* sample_rate);

// Optional fallback for non-RIFF inputs (FLAC/MP3/OGG/...): build.py registers
// libffdecode's ffdecode_decode here when libav is available, which makes
// every entry point (incl. the threaded batch decoder below) format-agnostic.
// Must be thread-safe and allocate the output with plain malloc.
typedef int (*wavio_fallback_fn)(const char*, float**, int64_t*, int32_t*);
static std::atomic<wavio_fallback_fn> g_fallback{nullptr};

void wavio_set_fallback_decoder(wavio_fallback_fn fn) { g_fallback.store(fn); }

int wavio_decode(const char* path, float** out, int64_t* n_samples, int32_t* sample_rate) {
    // exceptions (bad_alloc on corrupt sizes, etc.) must not cross the C ABI
    int rc;
    try {
        rc = wavio_decode_impl(path, out, n_samples, sample_rate);
    } catch (...) {
        *out = nullptr;
        *n_samples = 0;
        rc = 9;
    }
    // rc==1 is open-failure (missing file) — the fallback cannot help there
    wavio_fallback_fn fb = g_fallback.load();
    if (rc > 1 && fb != nullptr) {
        try {
            rc = fb(path, out, n_samples, sample_rate);
            if (rc != 0) rc += 20;  // distinguish fallback-stage failures
        } catch (...) {
            rc = 29;
        }
    }
    return rc;
}

static int wavio_decode_impl(const char* path, float** out, int64_t* n_samples,
                             int32_t* sample_rate) {
    *out = nullptr;
    *n_samples = 0;
    *sample_rate = 0;
    FILE* f = fopen(path, "rb");
    if (!f) return 1;

    char riff[4], wave[4];
    uint32_t riff_size;
    if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0 ||
        fread(&riff_size, 4, 1, f) != 1 ||
        fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) {
        fclose(f);
        return 2;
    }

    // bound all chunk allocations by the actual file size (streaming-recorder
    // WAVs in the wild carry 0xFFFFFFFF sizes in unpatched headers; a corrupt
    // size must not bad_alloc across the C ABI — per-file skip is the contract)
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return 2; }
    long file_size_l = ftell(f);
    if (file_size_l < 12) { fclose(f); return 2; }
    uint64_t file_size = (uint64_t)file_size_l;
    fseek(f, 12, SEEK_SET);

    uint16_t fmt_tag = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    bool got_fmt = false;
    std::vector<uint8_t> data;

    while (true) {
        char id[4];
        uint32_t size;
        if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
        long pos = ftell(f);
        uint64_t remain = (pos < 0 || (uint64_t)pos > file_size) ? 0 : file_size - (uint64_t)pos;
        uint64_t safe_size = size < remain ? size : remain;
        if (memcmp(id, "fmt ", 4) == 0) {
            if (safe_size < 16) { fclose(f); return 3; }  // legacy/truncated fmt
            std::vector<uint8_t> fmt((size_t)safe_size);
            if (fread(fmt.data(), 1, (size_t)safe_size, f) != (size_t)safe_size) {
                fclose(f);
                return 3;
            }
            if (safe_size & 1) fseek(f, 1, SEEK_CUR);  // RIFF pad byte
            fmt_tag = *(uint16_t*)&fmt[0];
            channels = *(uint16_t*)&fmt[2];
            rate = *(uint32_t*)&fmt[4];
            bits = *(uint16_t*)&fmt[14];
            if (fmt_tag == 0xFFFE && safe_size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
                fmt_tag = *(uint16_t*)&fmt[24];           // SubFormat first 2 bytes
            }
            got_fmt = true;
        } else if (memcmp(id, "data", 4) == 0) {
            data.resize((size_t)safe_size);
            size_t got = fread(data.data(), 1, (size_t)safe_size, f);
            data.resize(got);
            break;
        } else {
            if (fseek(f, (long)(safe_size + (safe_size & 1)), SEEK_CUR) != 0) break;
        }
    }
    fclose(f);
    if (!got_fmt || channels == 0 || rate == 0 || data.empty()) return 4;

    const int bytes_per = bits / 8;
    if (bytes_per == 0) return 5;
    const int64_t frames = (int64_t)data.size() / (bytes_per * channels);
    if (frames <= 0) return 5;

    float* mono = (float*)malloc(sizeof(float) * frames);
    if (!mono) return 6;
    const double inv_ch = 1.0 / channels;
    const uint8_t* p = data.data();

    for (int64_t i = 0; i < frames; i++) {
        double acc = 0.0;
        for (int c = 0; c < channels; c++) {
            const uint8_t* s = p + (i * channels + c) * bytes_per;
            double v = 0.0;
            if (fmt_tag == 1) {  // integer PCM
                switch (bits) {
                    case 8:  v = ((double)*s - 128.0) / 128.0; break;
                    case 16: v = (double)*(int16_t*)s / 32768.0; break;
                    case 24: {
                        int32_t x = (int32_t)(s[0] | (s[1] << 8) | (s[2] << 16));
                        if (x & 0x800000) x |= (int32_t)0xFF000000;
                        v = (double)x / 8388608.0;
                        break;
                    }
                    case 32: v = (double)*(int32_t*)s / 2147483648.0; break;
                    default: free(mono); return 7;
                }
            } else if (fmt_tag == 3) {  // IEEE float
                if (bits == 32) v = (double)*(float*)s;
                else if (bits == 64) v = *(double*)s;
                else { free(mono); return 7; }
            } else {
                free(mono);
                return 7;
            }
            acc += v;
        }
        mono[i] = (float)(acc * inv_ch);
    }

    *out = mono;
    *n_samples = frames;
    *sample_rate = (int32_t)rate;
    return 0;
}

void wavio_free(float* p) { free(p); }

// ---------------------------------------------------------------------------
// Windowed-sinc polyphase resample (same kernel as ops/resample.py)
// ---------------------------------------------------------------------------

static int64_t gcd64(int64_t a, int64_t b) { while (b) { int64_t t = a % b; a = b; b = t; } return a; }

// Output length = ceil(new_freq * n_in / orig_freq). Caller frees with wavio_free.
// The interior tiles are split over up to n_threads threads (one per 16
// tiles at least); every output is computed as on one thread.
int wavio_resample_threads(const float* in, int64_t n_in, int32_t orig_freq,
                           int32_t new_freq, int32_t lowpass_filter_width, double rolloff,
                           int32_t n_threads, float** out, int64_t* n_out) {
    *out = nullptr;
    *n_out = 0;
    if (orig_freq <= 0 || new_freq <= 0 || n_in <= 0) return 1;
    if (orig_freq == new_freq) {
        float* y = (float*)malloc(sizeof(float) * n_in);
        if (!y) return 6;
        memcpy(y, in, sizeof(float) * n_in);
        *out = y;
        *n_out = n_in;
        return 0;
    }
    const int64_t g = gcd64(orig_freq, new_freq);
    const int64_t orig = orig_freq / g, knew = new_freq / g;
    const double base_freq = (double)(orig < knew ? orig : knew) * rolloff;
    const int64_t width = (int64_t)ceil((double)lowpass_filter_width * orig / base_freq);
    const int64_t K = 2 * width + orig;

    // kernel[phase][tap]
    std::vector<double> kernel((size_t)(knew * K));
    for (int64_t ph = 0; ph < knew; ph++) {
        for (int64_t j = 0; j < K; j++) {
            double idx = (double)(j - width) / orig;
            double t = (-(double)ph / knew + idx) * base_freq;
            if (t < -lowpass_filter_width) t = -lowpass_filter_width;
            if (t > lowpass_filter_width) t = lowpass_filter_width;
            double w = cos(t * M_PI / lowpass_filter_width / 2.0);
            w *= w;
            double tp = t * M_PI;
            double sinc = (tp == 0.0) ? 1.0 : sin(tp) / tp;
            kernel[(size_t)(ph * K + j)] = sinc * w * (base_freq / orig);
        }
    }

    const int64_t target = (int64_t)ceil((double)knew * n_in / orig);
    float* y = (float*)malloc(sizeof(float) * target);
    if (!y) return 6;

    // x conceptually padded with `width` zeros left and `width + orig` right;
    // output sample m = frame m/knew, phase m%knew, and tap j reads
    // x[frame * orig - width + j]. Each output is one sum over its taps in
    // ascending order, started at 0.0.
    auto edge = [&](int64_t m) {
        const int64_t x0 = (m / knew) * orig - width;
        const double* kr = &kernel[(size_t)((m % knew) * K)];
        double acc = 0.0;
        int64_t j_lo = x0 < 0 ? -x0 : 0;
        int64_t j_hi = (x0 + K > n_in) ? (n_in - x0) : K;
        for (int64_t j = j_lo; j < j_hi; j++) acc += kr[j] * in[x0 + j];
        y[m] = (float)acc;
    };
    // Interior frames (all K taps inside x, all knew outputs wanted) go FT at
    // a time: their taps are packed as doubles, tap-major, and every phase's
    // FT sums run side by side, two phases at once. Each sum still adds its
    // taps in ascending order from 0.0, so the result is the edge loop's,
    // bit for bit; the side-by-side sums overlap their chains of adds.
    constexpr int64_t FT = 8;
    int64_t f_lo = (width + orig - 1) / orig;                 // first f: f*orig >= width
    int64_t f_hi = std::min((n_in - K + width) / orig + 1,    // f*orig - width + K <= n_in
                            target / knew);                   // (f+1)*knew <= target
    if (n_in - K + width < 0) f_hi = f_lo;
    if (f_hi < f_lo) f_hi = f_lo;
    const int64_t n_tiles = (f_hi - f_lo) / FT;
    for (int64_t m = 0; m < f_lo * knew && m < target; m++) edge(m);
    auto tiles = [&](int64_t t_lo, int64_t t_hi) {
        std::vector<double> pk((size_t)(K * FT));
        for (int64_t tile = t_lo; tile < t_hi; tile++) {
            const int64_t f0 = f_lo + tile * FT;
            for (int64_t j = 0; j < K; j++)
                for (int64_t t = 0; t < FT; t++)
                    pk[(size_t)(j * FT + t)] = in[(f0 + t) * orig - width + j];
            int64_t ph = 0;
            for (; ph + 2 <= knew; ph += 2) {
                const double* k0 = &kernel[(size_t)(ph * K)];
                const double* k1 = k0 + K;
                double a0[FT] = {}, a1[FT] = {};
                for (int64_t j = 0; j < K; j++) {
                    const double* p = &pk[(size_t)(j * FT)];
                    const double c0 = k0[j], c1 = k1[j];
                    for (int64_t t = 0; t < FT; t++) {
                        a0[t] += c0 * p[t];
                        a1[t] += c1 * p[t];
                    }
                }
                for (int64_t t = 0; t < FT; t++) {
                    y[(f0 + t) * knew + ph] = (float)a0[t];
                    y[(f0 + t) * knew + ph + 1] = (float)a1[t];
                }
            }
            for (; ph < knew; ph++) {
                const double* k0 = &kernel[(size_t)(ph * K)];
                double a0[FT] = {};
                for (int64_t j = 0; j < K; j++)
                    for (int64_t t = 0; t < FT; t++) a0[t] += k0[j] * pk[(size_t)(j * FT + t)];
                for (int64_t t = 0; t < FT; t++) y[(f0 + t) * knew + ph] = (float)a0[t];
            }
        }
    };
    // this thread runs share 0, and any share no thread could be started for
    const int64_t n_workers = std::max<int64_t>(
        1, std::min<int64_t>(n_threads, n_tiles / 16));
    std::vector<std::thread> workers;
    for (int64_t w = 1; w < n_workers; w++) {
        const int64_t lo = n_tiles * w / n_workers, hi = n_tiles * (w + 1) / n_workers;
        try {
            workers.emplace_back(tiles, lo, hi);
        } catch (const std::system_error&) {
            tiles(lo, hi);
        }
    }
    tiles(0, n_tiles / n_workers);
    for (auto& t : workers) t.join();

    for (int64_t m = std::max(f_lo * knew, (f_lo + n_tiles * FT) * knew); m < target; m++)
        edge(m);

    *out = y;
    *n_out = target;
    return 0;
}

int wavio_resample(const float* in, int64_t n_in, int32_t orig_freq, int32_t new_freq,
                   int32_t lowpass_filter_width, double rolloff,
                   float** out, int64_t* n_out) {
    return wavio_resample_threads(in, n_in, orig_freq, new_freq, lowpass_filter_width,
                                  rolloff, 1, out, n_out);
}

// ---------------------------------------------------------------------------
// Threaded batch decode(+resample) into caller-provided fixed-size buffers
// ---------------------------------------------------------------------------

// Decodes paths[i] (i < n_files) with `n_threads` worker threads, resamples to
// target_sr, trims to max_samples, writes into out[i*max_samples ...] (zero
// padded) and lengths[i]; status[i] = 0 on success. This is the host feed for
// the bucketed batcher: decode + resample overlap with device compute.
void wavio_decode_batch(const char** paths, int64_t n_files, int32_t target_sr,
                        int64_t max_samples, int32_t n_threads,
                        float* out, int64_t* lengths, int32_t* status) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        while (true) {
            int64_t i = next.fetch_add(1);
            if (i >= n_files) return;
            float* mono = nullptr;
            int64_t n = 0;
            int32_t sr = 0;
            int rc;
            try {
                rc = wavio_decode(paths[i], &mono, &n, &sr);
            } catch (...) {  // never let a worker exception std::terminate
                rc = 9;
                mono = nullptr;
            }
            if (rc != 0) {
                status[i] = rc;
                lengths[i] = 0;
                memset(out + i * max_samples, 0, sizeof(float) * max_samples);
                continue;
            }
            float* res = mono;
            int64_t n_res = n;
            if (sr != target_sr) {
                float* r = nullptr;
                int64_t nr = 0;
                rc = wavio_resample(mono, n, sr, target_sr, 6, 0.99, &r, &nr);
                free(mono);
                if (rc != 0) {
                    status[i] = 10 + rc;
                    lengths[i] = 0;
                    memset(out + i * max_samples, 0, sizeof(float) * max_samples);
                    continue;
                }
                res = r;
                n_res = nr;
            }
            int64_t keep = n_res < max_samples ? n_res : max_samples;
            memcpy(out + i * max_samples, res, sizeof(float) * keep);
            if (keep < max_samples)
                memset(out + i * max_samples + keep, 0, sizeof(float) * (max_samples - keep));
            lengths[i] = keep;
            status[i] = 0;
            free(res);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

}  // extern "C"
