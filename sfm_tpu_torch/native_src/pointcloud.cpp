// Native point-cloud runtime: the host-side equivalent of the reference's
// STLReader usage surface (addPointsToCloud / centerVolume / scaleVolume /
// writePLYPointCloud — main/main.cpp:95-99).  Exposed through a C ABI and
// loaded from Python via ctypes (sfm_tpu/io/ply.py).
//
// Binary little-endian PLY with optional uint8 colors; the writer streams
// through a 1 MiB buffer so multi-million-point clouds export at disk
// bandwidth.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>

extern "C" {

// Center the cloud on its centroid, in place.  n x 3 floats.
void pc_center(float* xyz, int64_t n) {
    if (n <= 0) return;
    double cx = 0, cy = 0, cz = 0;
    for (int64_t i = 0; i < n; ++i) {
        cx += xyz[3 * i];
        cy += xyz[3 * i + 1];
        cz += xyz[3 * i + 2];
    }
    cx /= n; cy /= n; cz /= n;
    for (int64_t i = 0; i < n; ++i) {
        xyz[3 * i] -= (float)cx;
        xyz[3 * i + 1] -= (float)cy;
        xyz[3 * i + 2] -= (float)cz;
    }
}

// Uniformly scale so the maximum |coord| equals target (STLReader's
// scaleVolume(500) semantics).  Returns the applied scale factor.
float pc_scale(float* xyz, int64_t n, float target) {
    float mx = 0.f;
    for (int64_t i = 0; i < 3 * n; ++i) {
        float a = std::fabs(xyz[i]);
        if (a > mx) mx = a;
    }
    if (mx <= 0.f) return 1.f;
    float s = target / mx;
    for (int64_t i = 0; i < 3 * n; ++i) xyz[i] *= s;
    return s;
}

// Normalize to unit RMS radius (normaliseVolume analogue).
void pc_normalize(float* xyz, int64_t n) {
    if (n <= 0) return;
    double sum = 0;
    for (int64_t i = 0; i < n; ++i) {
        double x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        sum += x * x + y * y + z * z;
    }
    double rms = std::sqrt(sum / n);
    if (rms <= 0) return;
    float inv = (float)(1.0 / rms);
    for (int64_t i = 0; i < 3 * n; ++i) xyz[i] *= inv;
}

// Write a binary PLY.  colors may be null (then no color properties).
// Returns 0 on success, nonzero errno-style code on failure.
int pc_write_ply(const char* path, const float* xyz, const uint8_t* rgb,
                 int64_t n) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    char header[512];
    int h = std::snprintf(
        header, sizeof(header),
        "ply\nformat binary_little_endian 1.0\n"
        "element vertex %lld\n"
        "property float x\nproperty float y\nproperty float z\n%s"
        "end_header\n",
        (long long)n,
        rgb ? "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            : "");
    if (std::fwrite(header, 1, (size_t)h, f) != (size_t)h) {
        std::fclose(f);
        return 2;
    }
    const size_t stride = rgb ? 15 : 12;
    std::vector<uint8_t> buf;
    const int64_t chunk = (1 << 20) / (int64_t)stride;
    buf.resize((size_t)chunk * stride);
    for (int64_t start = 0; start < n; start += chunk) {
        int64_t m = (n - start < chunk) ? (n - start) : chunk;
        uint8_t* p = buf.data();
        for (int64_t i = 0; i < m; ++i) {
            std::memcpy(p, xyz + 3 * (start + i), 12);
            p += 12;
            if (rgb) {
                std::memcpy(p, rgb + 3 * (start + i), 3);
                p += 3;
            }
        }
        if (std::fwrite(buf.data(), 1, (size_t)(m * stride), f)
            != (size_t)(m * stride)) {
            std::fclose(f);
            return 3;
        }
    }
    std::fclose(f);
    return 0;
}

// Read a binary or ascii PLY written by pc_write_ply (subset reader used in
// tests and for resuming).  Returns vertex count or -1; caller provides
// capacity-sized buffers.
int64_t pc_read_ply(const char* path, float* xyz, uint8_t* rgb,
                    int64_t capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char line[256];
    int64_t n = -1;
    bool has_color = false;
    while (std::fgets(line, sizeof(line), f)) {
        if (std::strncmp(line, "element vertex", 14) == 0)
            n = atoll(line + 14);
        if (std::strncmp(line, "property uchar red", 18) == 0)
            has_color = true;
        if (std::strncmp(line, "end_header", 10) == 0) break;
    }
    if (n < 0 || n > capacity) {
        std::fclose(f);
        return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        if (std::fread(xyz + 3 * i, 12, 1, f) != 1) { std::fclose(f); return -1; }
        if (has_color) {
            uint8_t c[3];
            if (std::fread(c, 3, 1, f) != 1) { std::fclose(f); return -1; }
            if (rgb) std::memcpy(rgb + 3 * i, c, 3);
        }
    }
    std::fclose(f);
    return n;
}

}  // extern "C"
