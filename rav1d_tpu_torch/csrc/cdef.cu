// CDEF of a frame, CUDA C++ for sm_90a: the direction search and the
// constrained filter of every 8x8 unit, luma and both chroma planes, in one
// launch (rav1d_cdef_frame).
//
// Replaces the XLA device kernel the JAX engine runs once a frame:
// rav1d_tpu/engine/filters.py cdef_pass_raw (:84) over
// rav1d_tpu/ops/tpu/cdef.py find_dir_batch (:55) and cdef_filter_batch
// (:105), called by rav1d_tpu/engine/mega.py filter_prog (:678). The
// port's plain version is engine/filters.py cdef_pass over ops/cdef.py
// find_dir_batch and cdef_filter_batch (engine/programs.py filter_plain);
// this kernel computes exactly what it computes.
//
// What the plain version computes: for each 8x8 luma unit (by, bx) of the
// (nby, nbx) grid, the direction and variance of its pre-CDEF luma block
// (reads clamped to the plane), the variance-adjusted primary strength,
// then the filter of the unit's luma pixels and, with the luma unit's
// direction (through uv_dirs for 4:2:2), of its (8 >> ss_ver, 8 >> ss_hor)
// chroma pixels at damping - 1, every tap read from the pre-CDEF planes:
// MISSING (-32768) outside the (ah, aw) plane and across a frame edge the
// unit may not cross (top: by > 0, bottom: 2 * by + 2 < bh, left: bx > 0,
// right: 2 * bx + 2 < bw). A unit with neither strength keeps its input.
// The direction costs are sums of squares that wrap in int32 and compare
// unsigned; the first maximum wins. The running minimum of the taps
// compares unsigned (MISSING never wins), the maximum signed. A right
// shift by an amount outside 0..31 (the secondary shift can be negative)
// fills with the sign, as the frameworks' shifts do.
//
// Design: one thread block per 64x64 luma area (8x8 units), 256 threads.
// Step 1: the block's first 64 threads take a unit each: its 64 pre-CDEF
// luma pixels, the eight direction costs in uint32, the variance, and the
// unit's strengths from the blob's byte maps into shared memory. Step 2:
// every thread filters pixels of the area, a row of the area across
// neighbouring threads (coalesced), luma then both chroma planes, each
// tap a read-only load of the pre-CDEF snapshot (the snapshot is the
// planes' copy the program makes for loop restoration anyway, so no unit
// reads a pixel another unit wrote). Only units with a strength write.
// The offset tables live in constant memory.
//
// Bound on this card: bytes. Each pre-CDEF plane is read once and the
// filtered units written once (25 MB for a 1080p 4:2:0 frame in int32
// words if every unit filters, 7.5 us at 3.35 TB/s); the arithmetic, a
// few hundred int32 operations per luma unit for the direction and about
// 120 per filtered pixel, comes to about 0.3 G operations, 18 us at the
// int32 issue rate, so the operations bind where most units filter. The
// taps' re-reads (up to 13 per pixel) hit L1.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_cdef_frame_host walks the same blocks with the same step
// functions, thread by thread, each barrier a loop boundary.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CD_HD __host__ __device__ __forceinline__
#define CD_CONST __constant__
#else
#define CD_HD static inline
#define CD_CONST static const
#endif

enum { CD_THREADS = 256, CD_MISSING = -32768 };

// (dy, dx) of each direction's two taps: the primary ring, and the two
// secondary rings (ops/cdef.py _PRI_OFF, _SEC1_OFF, _SEC2_OFF)
CD_CONST int CD_PRI[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
    {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
CD_CONST int CD_SEC1[8][2][2] = {
    {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}}, {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}, {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}};
CD_CONST int CD_SEC2[8][2][2] = {
    {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}, {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}},
    {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},  {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}}};
// chroma direction of each luma direction: 4:2:0 and 4:4:4, then 4:2:2
CD_CONST int CD_UV_DIRS[2][8] = {{0, 1, 2, 3, 4, 5, 6, 7}, {7, 0, 2, 4, 5, 6, 6, 6}};

// The launch's arguments (ops/cuda/filters.py CdefFrame, field for field).
struct CdefFrame {
    int* planes;       // (3, ah, aw) int32: the filtered units are written here
    const int* pre;    // (3, ah, aw) int32: the pre-CDEF (post-deblock) snapshot
    const int* blob;   // the frame blob
    int ah, aw;
    int ylvl, uvlvl;   // word offsets of the (nby, nbx) byte maps of levels
    int nby, nbx;      // 8x8 luma units
    int bh, bw;        // the frame in 4x4 blocks (the edge availability)
    int damping, bpc;
    int ss_hor, ss_ver;
    int uv422;         // -1 without chroma, 1 for 4:2:2, else 0
};

// per unit, in shared memory: [field][unit]
enum { U_FLAGS, U_YPRI, U_YSEC, U_YDIR, U_UVPRI, U_UVSEC, U_UVDIR, U_N };
enum { F_DOY = 1, F_DOUV = 2, F_T = 4, F_B = 8, F_L = 16, F_R = 32 };

CD_HD int cd_ld(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

CD_HD int cd_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// floor(log2(v)) for v >= 1 (ops/cdef.py ulog2)
CD_HD int cd_ulog2(int v) {
    int r = 0;
    for (int s = 16; s; s >>= 1)
        if ((v >> s) > 0) {
            r += s;
            v >>= s;
        }
    return r;
}

// a >> s with the frameworks' semantics: a shift outside 0..31 fills with
// the sign
CD_HD int cd_sar(int a, int s) { return (unsigned)s > 31u ? (a < 0 ? -1 : 0) : a >> s; }

CD_HD int cd_constrain(int diff, int thr, int shift) {
    const int ad = diff < 0 ? -diff : diff;
    int v = thr - cd_sar(ad, shift);
    v = v < 0 ? 0 : v;
    v = ad < v ? ad : v;
    return diff < 0 ? -v : v;
}

CD_HD unsigned cd_sq(int v) { return (unsigned)v * (unsigned)v; }

// The direction and variance of the 8x8 luma block at (oy, ox), reads
// clamped to the plane (ops/cdef.py find_dir_batch).
CD_HD void cd_find_dir(const CdefFrame& p, int oy, int ox, int* dir, int* var) {
    const int bd = p.bpc - 8;
    int px[64];
    for (int i = 0; i < 64; i++) {
        const int y = cd_clamp(oy + (i >> 3), 0, p.ah - 1);
        const int x = cd_clamp(ox + (i & 7), 0, p.aw - 1);
        px[i] = (cd_ld(p.pre + (size_t)y * p.aw + x) >> bd) - 128;
    }
    const unsigned div[7] = {840, 420, 280, 210, 168, 140, 120};
    unsigned cost[8];
    {  // horizontal and vertical lines
        unsigned c2 = 0, c6 = 0;
        for (int k = 0; k < 8; k++) {
            int h = 0, v = 0;
            for (int j = 0; j < 8; j++) {
                h += px[k * 8 + j];
                v += px[j * 8 + k];
            }
            c2 += cd_sq(h);
            c6 += cd_sq(v);
        }
        cost[2] = c2 * 105u;
        cost[6] = c6 * 105u;
    }
    for (int ci = 0; ci < 2; ci++) {  // the diagonals: bins y + x, 7 + y - x
        int d[15];
        for (int k = 0; k < 15; k++) d[k] = 0;
        for (int i = 0; i < 64; i++) {
            const int y = i >> 3, x = i & 7;
            d[ci ? 7 + y - x : y + x] += px[i];
        }
        unsigned c = cd_sq(d[7]) * 105u;
        for (int k = 0; k < 7; k++) c += (cd_sq(d[k]) + cd_sq(d[14 - k])) * div[k];
        cost[ci * 4] = c;
    }
    for (int k = 0; k < 4; k++) {  // the four half-angles
        int a[11];
        for (int j = 0; j < 11; j++) a[j] = 0;
        for (int i = 0; i < 64; i++) {
            const int y = i >> 3, x = i & 7;
            const int bin = k == 0 ? y + (x >> 1)
                            : k == 1 ? 3 + y - (x >> 1)
                            : k == 2 ? 3 - (y >> 1) + x
                                     : (y >> 1) + x;
            a[bin] += px[i];
        }
        unsigned c = 0;
        for (int j = 3; j < 8; j++) c += cd_sq(a[j]);
        c *= 105u;
        const unsigned d135[3] = {420, 210, 140};
        for (int j = 0; j < 3; j++) c += (cd_sq(a[j]) + cd_sq(a[10 - j])) * d135[j];
        cost[k * 2 + 1] = c;
    }
    int best = 0;
    for (int k = 1; k < 8; k++)
        if (cost[k] > cost[best]) best = k;
    *dir = best;
    *var = (int)((cost[best] - cost[best ^ 4]) >> 10);
}

// step 1: the units of the block (thread t < 64 takes unit t)
CD_HD void cd_units(const CdefFrame& p, int bx0, int by0, int* u, int t) {
    if (t >= 64) return;
    const int by = by0 + (t >> 3), bx = bx0 + (t & 7);
    if (by >= p.nby || bx >= p.nbx) {
        u[U_FLAGS * 64 + t] = 0;
        return;
    }
    const int bd = p.bpc - 8;
    const unsigned char* yb = (const unsigned char*)(p.blob + p.ylvl);
    const unsigned char* ub = (const unsigned char*)(p.blob + p.uvlvl);
    const int yl = yb[(size_t)by * p.nbx + bx], ul = ub[(size_t)by * p.nbx + bx];
    const int ypri = (yl >> 2) << bd;
    const int ysec = ((yl & 3) == 3 ? 4 : (yl & 3)) << bd;
    int dir, var;
    cd_find_dir(p, by * 8, bx * 8, &dir, &var);
    // variance-adjusted primary strength (cdef.rs adjust_strength)
    const int v6 = var >> 6;
    const int lg = cd_ulog2(cd_clamp(v6, 1, 4095));
    const int i = v6 >= 4096 ? 12 : (lg < 12 ? lg : 12);
    const int adj = (ypri * (4 + i) + 8) >> 4;
    const int pri = ypri > 0 ? (var == 0 ? 0 : adj) : 0;
    int flags = 0;
    if (pri > 0 || ysec > 0) flags |= F_DOY;
    if (ul != 0) flags |= F_DOUV;
    if (by > 0) flags |= F_T;
    if (by * 2 + 2 < p.bh) flags |= F_B;
    if (bx > 0) flags |= F_L;
    if (bx * 2 + 2 < p.bw) flags |= F_R;
    const int uvpri = (ul >> 2) << bd;
    u[U_FLAGS * 64 + t] = flags;
    u[U_YPRI * 64 + t] = pri;
    u[U_YSEC * 64 + t] = ysec;
    u[U_YDIR * 64 + t] = ypri > 0 ? dir : 0;
    u[U_UVPRI * 64 + t] = uvpri;
    u[U_UVSEC * 64 + t] = ((ul & 3) == 3 ? 4 : (ul & 3)) << bd;
    u[U_UVDIR * 64 + t] = uvpri > 0 && p.uv422 >= 0 ? CD_UV_DIRS[p.uv422][dir] : 0;
}

// A tap of a unit of size (h, w) at (oy, ox) of plane `src`: (r, c)
// relative to the unit, MISSING across an unavailable edge or outside the
// plane.
CD_HD int cd_tap(const CdefFrame& p, const int* src, int oy, int ox, int h, int w, int flags,
                 int r, int c) {
    if ((r < 0 && !(flags & F_T)) || (r >= h && !(flags & F_B)) || (c < 0 && !(flags & F_L)) ||
        (c >= w && !(flags & F_R)))
        return CD_MISSING;
    const int y = oy + r, x = ox + c;
    if (y < 0 || y >= p.ah || x < 0 || x >= p.aw) return CD_MISSING;
    return cd_ld(src + (size_t)y * p.aw + x);
}

// The filtered pixel (r, c) of a unit (ops/cdef.py cdef_filter_batch).
CD_HD int cd_pixel(const CdefFrame& p, const int* src, int oy, int ox, int h, int w, int flags,
                   int r, int c, int pri, int sec, int dir, int damping) {
    const int bd = p.bpc - 8;
    const int px = cd_tap(p, src, oy, ox, h, w, flags, r, c);
    const bool hp = pri > 0, hs = sec > 0, both = hp && hs;
    if (!hp && !hs) return px;
    int tap = 4 - ((pri >> bd) & 1);
    int psh = damping - (hp ? cd_ulog2(pri) : 0);
    psh = psh < 0 ? 0 : psh;
    const int ssh = damping - (hs ? cd_ulog2(sec) : 0);
    int s = 0, mn = px, mx = px;
#define CD_TRACK(v)                                          \
    if (both) {                                              \
        if ((unsigned)(v) < (unsigned)mn) mn = (v);          \
        if ((v) > mx) mx = (v);                              \
    }
    for (int k = 0; k < 2; k++) {
        const int dy = CD_PRI[dir][k][0], dx = CD_PRI[dir][k][1];
        const int p0 = cd_tap(p, src, oy, ox, h, w, flags, r + dy, c + dx);
        const int p1 = cd_tap(p, src, oy, ox, h, w, flags, r - dy, c - dx);
        if (hp) s += tap * (cd_constrain(p0 - px, pri, psh) + cd_constrain(p1 - px, pri, psh));
        CD_TRACK(p0);
        CD_TRACK(p1);
        tap = (tap & 3) | 2;
        const int ay = CD_SEC1[dir][k][0], ax = CD_SEC1[dir][k][1];
        const int by = CD_SEC2[dir][k][0], bx = CD_SEC2[dir][k][1];
        const int s0 = cd_tap(p, src, oy, ox, h, w, flags, r + ay, c + ax);
        const int s1 = cd_tap(p, src, oy, ox, h, w, flags, r - ay, c - ax);
        const int s2 = cd_tap(p, src, oy, ox, h, w, flags, r + by, c + bx);
        const int s3 = cd_tap(p, src, oy, ox, h, w, flags, r - by, c - bx);
        if (hs)
            s += (2 - k) * (cd_constrain(s0 - px, sec, ssh) + cd_constrain(s1 - px, sec, ssh) +
                            cd_constrain(s2 - px, sec, ssh) + cd_constrain(s3 - px, sec, ssh));
        CD_TRACK(s0);
        CD_TRACK(s1);
        CD_TRACK(s2);
        CD_TRACK(s3);
    }
#undef CD_TRACK
    int out = px + ((s - (s < 0) + 8) >> 4);
    if (both) {
        out = out < mx ? out : mx;
        out = out > mn ? out : mn;
    }
    return out;
}

// step 2: the area's pixels, luma then the chroma planes
CD_HD void cd_filter(const CdefFrame& p, int bx0, int by0, const int* u, int t) {
    const size_t psz = (size_t)p.ah * p.aw;
    for (int i = t; i < 64 * 64; i += CD_THREADS) {
        const int y = i >> 6, x = i & 63, k = (y >> 3) * 8 + (x >> 3);
        const int flags = u[U_FLAGS * 64 + k];
        if (!(flags & F_DOY)) continue;
        const int oy = (by0 + (y >> 3)) * 8, ox = (bx0 + (x >> 3)) * 8;
        if (oy + (y & 7) >= p.ah || ox + (x & 7) >= p.aw) continue;
        p.planes[(size_t)(oy + (y & 7)) * p.aw + ox + (x & 7)] =
            cd_pixel(p, p.pre, oy, ox, 8, 8, flags, y & 7, x & 7, u[U_YPRI * 64 + k],
                     u[U_YSEC * 64 + k], u[U_YDIR * 64 + k], p.damping);
    }
    if (p.uv422 < 0) return;
    const int ch = 8 >> p.ss_ver, cw = 8 >> p.ss_hor, rw = 8 * cw;
    for (int pl = 1; pl < 3; pl++) {
        for (int i = t; i < 64 * ch * cw; i += CD_THREADS) {
            const int y = i / rw, x = i % rw, k = (y / ch) * 8 + x / cw;
            const int flags = u[U_FLAGS * 64 + k];
            if (!(flags & F_DOUV)) continue;
            const int oy = (by0 + y / ch) * ch, ox = (bx0 + x / cw) * cw;
            if (oy + y % ch >= p.ah || ox + x % cw >= p.aw) continue;
            p.planes[pl * psz + (size_t)(oy + y % ch) * p.aw + ox + x % cw] =
                cd_pixel(p, p.pre + pl * psz, oy, ox, ch, cw, flags, y % ch, x % cw,
                         u[U_UVPRI * 64 + k], u[U_UVSEC * 64 + k], u[U_UVDIR * 64 + k],
                         p.damping - 1);
        }
    }
}

CD_HD bool cd_ok(const CdefFrame& p) {
    return p.bpc >= 8 && p.bpc <= 12 && p.uv422 >= -1 && p.uv422 <= 1 && p.ss_hor >= 0 &&
           p.ss_hor <= 1 && p.ss_ver >= 0 && p.ss_ver <= 1;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(CD_THREADS) cdef_frame_kernel(const __grid_constant__ CdefFrame p) {
    __shared__ int u[U_N * 64];
    const int bx0 = blockIdx.x * 8, by0 = blockIdx.y * 8;
    cd_units(p, bx0, by0, u, threadIdx.x);
    __syncthreads();
    cd_filter(p, bx0, by0, u, threadIdx.x);
}

// Plain C entry (bound with ctypes): one launch over the frame's units on
// `stream`. Returns the launch's error code (-1 for arguments the kernel
// does not take).
extern "C" int rav1d_cdef_frame(const CdefFrame* f, void* stream) {
    if (!cd_ok(*f)) return -1;
    if (f->nby <= 0 || f->nbx <= 0) return 0;
    const dim3 grid((f->nbx + 7) / 8, (f->nby + 7) / 8);
    cdef_frame_kernel<<<grid, CD_THREADS, 0, (cudaStream_t)stream>>>(*f);
    return (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

// rav1d_cdef_frame without the stream: every block in order, each step
// for every thread in turn.
extern "C" int rav1d_cdef_frame_host(const CdefFrame* f) {
    const CdefFrame& p = *f;
    if (!cd_ok(p)) return -1;
    int u[U_N * 64];
    for (int by0 = 0; by0 < p.nby; by0 += 8)
        for (int bx0 = 0; bx0 < p.nbx; bx0 += 8) {
            for (int& w : u) w = 0x5a5a5a5a;
            for (int t = 0; t < CD_THREADS; t++) cd_units(p, bx0, by0, u, t);
            for (int t = 0; t < CD_THREADS; t++) cd_filter(p, bx0, by0, u, t);
        }
    return 0;
}

// The constant tables, for the tests: CD_PRI, CD_SEC1, CD_SEC2, CD_UV_DIRS
// (112 ints)
extern "C" int rav1d_cdef_tables_host(int* out) {
    int n = 0;
    for (int d = 0; d < 8; d++)
        for (int k = 0; k < 2; k++)
            for (int j = 0; j < 2; j++) out[n++] = CD_PRI[d][k][j];
    for (int d = 0; d < 8; d++)
        for (int k = 0; k < 2; k++)
            for (int j = 0; j < 2; j++) out[n++] = CD_SEC1[d][k][j];
    for (int d = 0; d < 8; d++)
        for (int k = 0; k < 2; k++)
            for (int j = 0; j < 2; j++) out[n++] = CD_SEC2[d][k][j];
    for (int i = 0; i < 2; i++)
        for (int d = 0; d < 8; d++) out[n++] = CD_UV_DIRS[i][d];
    return n;
}

#endif  // __CUDACC__
