// The init tiler's spill pass (ops/tiled.init_tiles), on the host.
//
// The particles past a home tile's capacity go, in the order given (the
// caller passes them in ascending particle order), to the first interior
// tile with room on the Chebyshev rings around their home: rings from 1
// outward, each ring's boundary in row-major order (dy ascending, then
// dx ascending), as the JAX package's native tiler and numpy path place
// them.  The tile's next slot is taken (fill[tile] grows by one).
//
// A tile found full stays full (fill only grows), so each home tile keeps
// a cursor: the ring and the position on it where its last search ended;
// the next particle of that home resumes there, or one ring inside the
// farthest cursor of its 8 neighbours when that is farther (every ring
// inside it lies in a square that neighbour found full).  A dense pile's
// spills would otherwise each walk every ring out to the pile's edge.
//
// Build: g++ -O3 -march=native -fPIC -shared -std=c++17 (ops/_native.py
// builds it at first use).  ABI: plain C through ctypes.

#include <algorithm>
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

}  // namespace

extern "C" {

// hy, hx: the m spills' home tile coordinates (interior), in order.
// fill: TY*TX slot counts, updated.  out: the flat slot index
// (k * TY * TX + tile) of each spill, or -1 when no interior tile has
// room.  Returns the number of spills without room.
int64_t gpe_spill_tiles(const int64_t* hy, const int64_t* hx, int64_t m,
                        int64_t* fill, int32_t cap, int32_t ty_n,
                        int32_t tx_n, int64_t* out) {
    const int64_t ntiles = (int64_t)ty_n * tx_n;
    const int32_t last = std::max(ty_n, tx_n);  // rings 1 .. last - 1
    std::vector<int32_t> ring(ntiles, 0), pos(ntiles, 0);  // 0: unseen
    int64_t dropped = 0;
    for (int64_t j = 0; j < m; ++j) {
        const int32_t y = (int32_t)hy[j], x = (int32_t)hx[j];
        const int64_t h = (int64_t)y * tx_n + x;
        int32_t r = ring[h], p = pos[h];
        if (r == 0) {
            r = 1;
            p = 0;
        }
        int32_t near = 0;
        for (int32_t dy = -1; dy <= 1; ++dy)
            for (int32_t dx = -1; dx <= 1; ++dx) {
                const int32_t ny = y + dy, nx = x + dx;
                if (ny >= 0 && ny < ty_n && nx >= 0 && nx < tx_n)
                    near = std::max(near, ring[(int64_t)ny * tx_n + nx]);
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
                if (sy < 1 || sy > ty_n - 2 || sx < 1 || sx > tx_n - 2)
                    continue;
                const int64_t t = (int64_t)sy * tx_n + sx;
                if (fill[t] < cap) {
                    tile = t;
                    break;
                }
            }
            if (tile >= 0) break;
        }
        ring[h] = r;
        pos[h] = p;
        if (tile < 0) {
            out[j] = -1;
            ++dropped;
            continue;
        }
        out[j] = fill[tile] * ntiles + tile;
        fill[tile] += 1;
    }
    return dropped;
}

}  // extern "C"
