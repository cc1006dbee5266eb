// The init tiler (ops/tiled.init_tiles), on the host: the JAX package's
// native binning pass (gpu_physics_engine_tpu/native/tiler.cpp
// bin_particles), whose layout JAX's init_tiles takes whenever g++ builds
// it.
//
// Every particle's home tile is floor(x * (1/t)) + 1 per axis, with the
// reciprocal 1/t rounded to f32 and one f32 product (a lone product: no
// build flag can contract it into anything), clamped to the interior
// 1..TX-2, 1..TY-2.  Natives go first, in ascending particle order, each
// to its home's next slot.  The particles past a full home then go, in
// ascending particle order, to the first interior tile with room on the
// Chebyshev rings around their home: rings from 1 outward, each ring's
// boundary in row-major order (dy ascending, then dx ascending).  The
// tile's next slot is taken.
//
// A tile found full stays full (fill only grows), so each home tile keeps
// a cursor: the ring and the position on it where its last search ended;
// the next spill of that home resumes there, or one ring inside the
// farthest cursor of its 8 neighbours when that is farther (every ring
// inside it lies in a square that neighbour found full).  A dense pile's
// spills would otherwise each walk every ring out to the pile's edge.
//
// Build: g++ -O3 -march=native -fPIC -shared -std=c++17 (ops/_native.py
// builds it at first use).  ABI: plain C through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// (dy, dx) of position p (0 <= p < 8r) on ring r, row-major
inline void ring_pos(int32_t r, int32_t p, int32_t* dy, int32_t* dx) {
    const int32_t row = 2 * r + 1;
    if (p < row) {
        *dy = -r;
        *dx = p - r;
        return;
    }
    p -= row;
    if (p < 2 * (2 * r - 1)) {
        *dy = -r + 1 + p / 2;
        *dx = (p % 2 == 0) ? -r : r;
        return;
    }
    p -= 2 * (2 * r - 1);
    *dy = r;
    *dx = p - r;
}

// The spill search with its per-home cursors (above).
class Spiller {
  public:
    Spiller(int32_t ty_n, int32_t tx_n)
        : ty_n_(ty_n), tx_n_(tx_n),
          ring_((int64_t)ty_n * tx_n, 0), pos_((int64_t)ty_n * tx_n, 0) {}

    // The first interior tile with fill < cap around home (y, x), or -1.
    int64_t find(int32_t y, int32_t x, const int32_t* fill, int32_t cap) {
        const int32_t last = std::max(ty_n_, tx_n_);  // rings 1 .. last - 1
        const int64_t h = (int64_t)y * tx_n_ + x;
        int32_t r = ring_[h], p = pos_[h];
        if (r == 0) {  // unseen
            r = 1;
            p = 0;
        }
        int32_t near = 0;
        for (int32_t dy = -1; dy <= 1; ++dy)
            for (int32_t dx = -1; dx <= 1; ++dx) {
                const int32_t ny = y + dy, nx = x + dx;
                if (ny >= 0 && ny < ty_n_ && nx >= 0 && nx < tx_n_)
                    near = std::max(near, ring_[(int64_t)ny * tx_n_ + nx]);
            }
        if (near - 1 > r) {
            r = near - 1;
            p = 0;
        }
        int64_t tile = -1;
        for (; r < last; ++r, p = 0) {
            for (; p < 8 * r; ++p) {
                int32_t dy, dx;
                ring_pos(r, p, &dy, &dx);
                const int32_t sy = y + dy, sx = x + dx;
                if (sy < 1 || sy > ty_n_ - 2 || sx < 1 || sx > tx_n_ - 2)
                    continue;
                const int64_t t = (int64_t)sy * tx_n_ + sx;
                if (fill[t] < cap) {
                    tile = t;
                    break;
                }
            }
            if (tile >= 0) break;
        }
        ring_[h] = r;
        pos_[h] = p;
        return tile;
    }

  private:
    int32_t ty_n_, tx_n_;
    std::vector<int32_t> ring_, pos_;
};

}  // namespace

extern "C" {

// positions, prev: n * 2 f32 (x, y); radii: n f32; pids: n i32.
// out_*: cap * TY * TX slot-major planes, out_pid filled with -1 and the
// others with 0 by the caller.  Returns the number of particles dropped
// (no interior tile with room: the whole grid is full).
int64_t gpe_bin_tiles(const float* positions, const float* prev,
                      const float* radii, const int32_t* pids, int64_t n,
                      float tile_edge, int32_t cap, int32_t ty_n,
                      int32_t tx_n, float* out_x, float* out_y,
                      float* out_px, float* out_py, float* out_r,
                      int32_t* out_pid) {
    const int64_t ntiles = (int64_t)ty_n * tx_n;
    const float inv_t = 1.0f / tile_edge;
    std::vector<int32_t> fill(ntiles, 0);

    auto home_of = [&](int64_t i, int32_t* oty, int32_t* otx) {
        const int32_t tx = (int32_t)std::floor(positions[2 * i] * inv_t) + 1;
        const int32_t ty =
            (int32_t)std::floor(positions[2 * i + 1] * inv_t) + 1;
        *otx = std::min(std::max(tx, 1), tx_n - 2);
        *oty = std::min(std::max(ty, 1), ty_n - 2);
    };
    auto place = [&](int64_t i, int64_t tile) {
        const int64_t slot = (int64_t)fill[tile] * ntiles + tile;
        fill[tile] += 1;
        out_x[slot] = positions[2 * i];
        out_y[slot] = positions[2 * i + 1];
        out_px[slot] = prev[2 * i];
        out_py[slot] = prev[2 * i + 1];
        out_r[slot] = radii[i];
        out_pid[slot] = pids[i];
    };

    std::vector<int64_t> overflow;
    for (int64_t i = 0; i < n; ++i) {
        int32_t ty, tx;
        home_of(i, &ty, &tx);
        const int64_t tile = (int64_t)ty * tx_n + tx;
        if (fill[tile] >= cap) {
            overflow.push_back(i);
            continue;
        }
        place(i, tile);
    }
    Spiller spill(ty_n, tx_n);
    int64_t dropped = 0;
    for (const int64_t i : overflow) {
        int32_t ty, tx;
        home_of(i, &ty, &tx);
        const int64_t tile = spill.find(ty, tx, fill.data(), cap);
        if (tile < 0) {
            ++dropped;
            continue;
        }
        place(i, tile);
    }
    return dropped;
}

}  // extern "C"
