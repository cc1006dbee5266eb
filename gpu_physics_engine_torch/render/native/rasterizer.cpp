// Native point-splat rasterizer: the port's copy of
// gpu_physics_engine_tpu/render/native/rasterizer.cpp.
//
// Each particle is a soft-edged circle: alpha = 1 - smoothstep(0.2304, 0.25,
// d^2) in quad-local coordinates (particle_drawer.wgsl:69-81), alpha-blended
// in draw order over the existing framebuffer contents.  TiledEngine
// splats the big-particle overlay over the device frame with it, and the
// host viewer (render/viewer.py) whole frames; draw_lines draws the grid.
//
// Build: render/rasterizer.py runs g++ with the JAX package's Makefile
// flags at first use, into gpu_physics_engine_torch/_build/.
// ABI: plain C, consumed via ctypes.

#include <cstdint>
#include <cmath>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float smoothstep(float e0, float e1, float x) {
    float t = std::min(std::max((x - e0) / (e1 - e0), 0.0f), 1.0f);
    return t * t * (3.0f - 2.0f * t);
}

// Blend every particle into screen rows [band_y0, band_y1]. Particle order
// is preserved within each pixel, so banding keeps the output identical to
// the serial pass — each thread owns a disjoint band (no races) and skips
// quads that don't touch it (per-particle setup is duplicated, pixel work
// is split).
void splat_band(float* __restrict fb, int width, int height,
                int band_y0, int band_y1,
                const float* __restrict sx, const float* __restrict sy,
                const float* __restrict sr, const float* __restrict rgb,
                int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        const float cx = sx[i];
        const float cy = sy[i];
        const float r = sr[i];
        if (r <= 0.0f) continue;
        // the quad spans radius*2 in world units; local coords in [-0.5, 0.5];
        // alpha is zero at local dist^2 >= 0.25, i.e. beyond 0.5*quad px from
        // the center — pad by half a pixel for pixel-center sampling
        const float quad = 2.0f * r;           // quad edge in pixels
        const float inv_quad = 1.0f / quad;
        const float half = 0.5f * quad + 0.5f;
        int x0 = (int)std::floor(cx - half), x1 = (int)std::ceil(cx + half - 1.0f);
        int y0 = (int)std::floor(cy - half), y1 = (int)std::ceil(cy + half - 1.0f);
        x0 = std::max(x0, 0); y0 = std::max(y0, band_y0);
        x1 = std::min(x1, width - 1); y1 = std::min(y1, band_y1);
        if (x0 > x1 || y0 > y1) continue;
        const float cr = rgb[3 * i], cg = rgb[3 * i + 1], cb = rgb[3 * i + 2];
        for (int y = y0; y <= y1; ++y) {
            float* row = fb + (int64_t)3 * ((int64_t)y * width);
            const float ly = (y + 0.5f - cy) * inv_quad;
            const float ly2 = ly * ly;
            for (int x = x0; x <= x1; ++x) {
                const float lx = (x + 0.5f - cx) * inv_quad;
                const float d2 = lx * lx + ly2;
                if (d2 >= 0.25f) continue;
                const float alpha = 1.0f - smoothstep(0.2304f, 0.25f, d2);
                if (alpha <= 0.0f) continue;
                float* px = row + 3 * x;
                px[0] += (cr - px[0]) * alpha;
                px[1] += (cg - px[1]) * alpha;
                px[2] += (cb - px[2]) * alpha;
            }
        }
    }
}

}  // namespace

extern "C" {

// framebuffer: H*W*3 float32 RGB in [0,1], row-major, y-down.
// sx, sy: screen-space particle centers (pixels); sr: screen-space radius.
// rgb: N*3 per-particle color.  Particles are blended in index order.
void splat_particles(float* __restrict fb, int width, int height,
                     const float* __restrict sx, const float* __restrict sy,
                     const float* __restrict sr, const float* __restrict rgb,
                     int64_t n) {
#ifdef _OPENMP
    #pragma omp parallel
    {
        const int nt = omp_get_num_threads();
        const int t = omp_get_thread_num();
        const int rows = (height + nt - 1) / nt;
        const int y0 = t * rows;
        const int y1 = std::min(y0 + rows - 1, height - 1);
        if (y0 <= y1)
            splat_band(fb, width, height, y0, y1, sx, sy, sr, rgb, n);
    }
#else
    splat_band(fb, width, height, 0, height - 1, sx, sy, sr, rgb, n);
#endif
}

// Axis-aligned line list: each line k covers pixels along x (horizontal=1)
// or y, with the given color and 1px thickness.  Used by the grid drawer.
void draw_lines(float* __restrict fb, int width, int height,
                const float* __restrict a, const float* __restrict b,
                const float* __restrict rgb, const uint8_t* __restrict horiz,
                int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        const float cr = rgb[3 * i], cg = rgb[3 * i + 1], cb = rgb[3 * i + 2];
        if (horiz[i]) {
            const int y = (int)std::lround(a[2 * i + 1]);
            if (y < 0 || y >= height) continue;
            int x0 = std::max((int)std::lround(a[2 * i]), 0);
            int x1 = std::min((int)std::lround(b[2 * i]), width - 1);
            float* row = fb + (int64_t)3 * ((int64_t)y * width);
            for (int x = x0; x <= x1; ++x) {
                row[3 * x] = cr; row[3 * x + 1] = cg; row[3 * x + 2] = cb;
            }
        } else {
            const int x = (int)std::lround(a[2 * i]);
            if (x < 0 || x >= width) continue;
            int y0 = std::max((int)std::lround(a[2 * i + 1]), 0);
            int y1 = std::min((int)std::lround(b[2 * i + 1]), height - 1);
            for (int y = y0; y <= y1; ++y) {
                float* px = fb + (int64_t)3 * ((int64_t)y * width + x);
                px[0] = cr; px[1] = cg; px[2] = cb;
            }
        }
    }
}

}  // extern "C"
