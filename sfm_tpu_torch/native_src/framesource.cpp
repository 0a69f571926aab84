// Native video frame source: the host-side equivalent of the reference's
// cv::VideoCapture usage (main/main.cpp:41, 71-83 — decode a frame, hand
// it to the engine).  No OpenCV/ffmpeg in the image, so the container is
// YUV4MPEG2 (420/422/444 planar, 8-bit), the same format the framework's
// debug writer emits (sfm_tpu/viz.py Y4MWriter).
//
// Decoding runs on a background prefetch thread into a bounded ring of
// fully-converted frames (gray f32 = the Y plane; RGB u8 via BT.601 with
// nearest-neighbor chroma upsampling — bit-identical to the Python
// Y4MSource in sfm_tpu/io/video.py), so the conversion overlaps the
// consumer's device work.  Exposed through a C ABI and loaded from
// Python via ctypes.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
    std::vector<float> gray;    // [H*W]
    std::vector<uint8_t> rgb;   // [H*W*3]
};

struct Source {
    FILE* f = nullptr;
    int w = 0, h = 0;
    int cw = 0, ch = 0;         // chroma plane dims
    double fps = 0.0;
    size_t prefetch = 4;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_put, cv_get;
    std::deque<Frame> ring;
    bool eof = false;
    std::atomic<bool> stop{false};

    ~Source() {
        stop.store(true);
        cv_put.notify_all();
        cv_get.notify_all();
        if (worker.joinable()) worker.join();
        if (f) fclose(f);
    }
};

bool read_line(FILE* f, std::string& out) {
    out.clear();
    int c;
    while ((c = fgetc(f)) != EOF) {
        if (c == '\n') return true;
        out.push_back((char)c);
    }
    return !out.empty();
}

inline uint8_t clamp_u8(float v) {
    return (uint8_t)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
}

// Decode one frame's planes into gray f32 + RGB u8 (matches the Python
// reader: gray is the raw luma plane; chroma upsampled by repetition).
void convert(const Source& s, const uint8_t* y, const uint8_t* u,
             const uint8_t* v, Frame& out) {
    const int W = s.w, H = s.h, CW = s.cw, CH = s.ch;
    const int sx = W / CW, sy = H / CH;
    out.gray.resize((size_t)W * H);
    out.rgb.resize((size_t)W * H * 3);
    for (int r = 0; r < H; ++r) {
        const uint8_t* yrow = y + (size_t)r * W;
        const uint8_t* urow = u + (size_t)(r / sy) * CW;
        const uint8_t* vrow = v + (size_t)(r / sy) * CW;
        float* grow = out.gray.data() + (size_t)r * W;
        uint8_t* crow = out.rgb.data() + (size_t)r * W * 3;
        for (int cidx = 0; cidx < W; ++cidx) {
            float yf = (float)yrow[cidx];
            float uf = (float)urow[cidx / sx] - 128.0f;
            float vf = (float)vrow[cidx / sx] - 128.0f;
            grow[cidx] = yf;
            crow[3 * cidx + 0] = clamp_u8(yf + 1.402f * vf);
            crow[3 * cidx + 1] =
                clamp_u8(yf - 0.344136f * uf - 0.714136f * vf);
            crow[3 * cidx + 2] = clamp_u8(yf + 1.772f * uf);
        }
    }
}

void decode_loop(Source* s) {
    const size_t ybytes = (size_t)s->w * s->h;
    const size_t cbytes = (size_t)s->cw * s->ch;
    std::vector<uint8_t> buf(ybytes + 2 * cbytes);
    std::string marker;
    while (!s->stop.load()) {
        if (!read_line(s->f, marker) ||
            marker.compare(0, 5, "FRAME") != 0) break;
        if (fread(buf.data(), 1, buf.size(), s->f) != buf.size()) break;
        Frame fr;
        convert(*s, buf.data(), buf.data() + ybytes,
                buf.data() + ybytes + cbytes, fr);
        std::unique_lock<std::mutex> lk(s->mu);
        s->cv_put.wait(lk, [s] {
            return s->ring.size() < s->prefetch || s->stop.load();
        });
        if (s->stop.load()) break;
        s->ring.push_back(std::move(fr));
        s->cv_get.notify_one();
    }
    std::lock_guard<std::mutex> lk(s->mu);
    s->eof = true;
    s->cv_get.notify_all();
}

}  // namespace

extern "C" {

// Open a .y4m file with a `prefetch`-deep decode-ahead ring.
// Returns NULL on parse failure.
void* fs_open(const char* path, int prefetch) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    std::string header;
    if (!read_line(f, header) ||
        header.compare(0, 9, "YUV4MPEG2") != 0) {
        fclose(f);
        return nullptr;
    }
    auto* s = new Source();
    s->f = f;
    s->prefetch = prefetch > 0 ? (size_t)prefetch : 4;
    std::string cs = "420";
    size_t pos = 9;
    while (pos < header.size()) {
        while (pos < header.size() && header[pos] == ' ') ++pos;
        size_t end = header.find(' ', pos);
        if (end == std::string::npos) end = header.size();
        if (end > pos) {
            char tag = header[pos];
            std::string val = header.substr(pos + 1, end - pos - 1);
            if (tag == 'W') s->w = atoi(val.c_str());
            else if (tag == 'H') s->h = atoi(val.c_str());
            else if (tag == 'C') cs = val;
            else if (tag == 'F') {
                int num = 0, den = 1;
                if (sscanf(val.c_str(), "%d:%d", &num, &den) == 2 && den)
                    s->fps = (double)num / den;
            }
        }
        pos = end;
    }
    if (s->w <= 0 || s->h <= 0) {
        delete s;
        return nullptr;
    }
    if (cs.compare(0, 3, "420") == 0) { s->cw = s->w / 2; s->ch = s->h / 2; }
    else if (cs.compare(0, 3, "422") == 0) { s->cw = s->w / 2; s->ch = s->h; }
    else { s->cw = s->w; s->ch = s->h; }
    s->worker = std::thread(decode_loop, s);
    return s;
}

void fs_info(void* handle, int* w, int* h, double* fps) {
    auto* s = (Source*)handle;
    if (w) *w = s->w;
    if (h) *h = s->h;
    if (fps) *fps = s->fps;
}

// Copy the next frame into caller buffers (gray [H*W] f32 required,
// rgb [H*W*3] u8 optional/NULL).  Blocks until a frame is decoded.
// Returns 1 on success, 0 at end of stream.
int fs_next(void* handle, float* gray, uint8_t* rgb) {
    auto* s = (Source*)handle;
    Frame fr;
    {
        std::unique_lock<std::mutex> lk(s->mu);
        s->cv_get.wait(lk, [s] { return !s->ring.empty() || s->eof; });
        if (s->ring.empty()) return 0;
        fr = std::move(s->ring.front());
        s->ring.pop_front();
        s->cv_put.notify_one();
    }
    memcpy(gray, fr.gray.data(), fr.gray.size() * sizeof(float));
    if (rgb) memcpy(rgb, fr.rgb.data(), fr.rgb.size());
    return 1;
}

void fs_close(void* handle) {
    delete (Source*)handle;
}

}  // extern "C"
