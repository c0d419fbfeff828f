// CDEF of a frame, CUDA C++ for sm_90a: the direction search and the
// constrained filter of every 8x8 unit, luma and both chroma planes, in one
// launch. Two forms:
// - rav1d_cdef (kernel cdef_area_kernel): the form on the decoder path
//   (ops/cuda/filters.py cdef_frame);
// - rav1d_cdef_frame (kernel cdef_frame_kernel): the earlier form, kept
//   for comparison (ops/cuda/filters.py cdef_frame_global); no decoder
//   path runs it.
//
// Both replace the XLA device kernel the JAX engine runs once a frame:
// rav1d_tpu/engine/filters.py cdef_pass_raw (:84) over
// rav1d_tpu/ops/tpu/cdef.py find_dir_batch (:55) and cdef_filter_batch
// (:105), called by rav1d_tpu/engine/mega.py filter_prog (:678). The
// port's plain version is engine/filters.py cdef_pass over ops/cdef.py
// find_dir_batch and cdef_filter_batch (engine/programs.py filter_plain);
// both compute exactly what it computes.
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
// Design of rav1d_cdef: one thread block per 64x64 luma area (8x8 units),
// 256 threads, seven steps at block barriers. (0) The flags cleared. (1)
// The first 64 threads read their units' level bytes: an area with no
// strength anywhere reads and writes nothing further. (2) The area's
// pre-CDEF luma (where a unit has a luma strength or needs a direction)
// and each chroma plane's area (where a unit has a chroma strength) go
// into shared memory with a 2-pixel halo (68 x 68 luma words, 36 x 36 a
// 4:2:0 chroma plane; rows 72 or 36 words apart, so that the rows of a
// unit a warp filters fall on distinct banks), a row across neighbouring
// threads (coalesced; 8 loads a thread in flight together), MISSING
// written where the plain version returns it: outside the plane, and past
// the last unit row or column of the frame (only the last unit row lacks
// a bottom neighbour, only the last column a right one, and the top and
// left edges of the frame are the plane's, so this fill equals the
// per-tap edge tests; the planes cover the unit grid); the tap offsets of
// the 8 directions at the luma and chroma pitches (computed from packed
// literals). (3) The luma of each unit that needs a direction, biased,
// copied from the tile unit by unit at a pitch of 65 words. (4) The direction search on every thread: each warp
// takes 32 units and two of the eight costs (the pair is the same across
// the warp, so every bin index is a constant after unrolling: no
// per-thread array is indexed at run time), reading each unit's 64 words
// (lane = unit, conflict-free at pitch 65). (5) The first 64 threads take
// the first maximum of their unit's costs, the variance, the adjusted
// strengths and the shifts, and list the units that filter, per plane
// kind. (6) Every thread filters pixels of the listed units only, luma
// then both chroma planes, neighbouring threads on neighbouring pixels of
// one unit (a warp's lanes share a unit's strengths and direction: no
// lane idles on a unit that keeps its pixels, and the branches on the
// strengths are the same across the warp): every tap one shared-memory
// read with no test, each shift a plain one (its amount clamped to 31 per
// unit, which is cd_sar's sign fill).
//
// Bound on this card: operations where most units filter. Each pre-CDEF
// plane is read once and the filtered units written once (25 MB for a
// 1080p 4:2:0 frame in int32 words if every unit filters, 7.5 us at 3.35
// TB/s); the arithmetic, a few hundred int32 operations per luma unit for
// the direction and about 140 per filtered pixel, comes to about 0.3-0.7 G
// operations, 18-43 us at the int32 instruction rate.
//
// Design of rav1d_cdef_frame (the earlier form): one thread block per
// 64x64 luma area, 256 threads. Step 1: the block's first 64 threads take
// a unit each: its 64 pre-CDEF luma pixels from global memory, the eight
// direction costs, the variance, and the unit's strengths into shared
// memory. Step 2: every thread filters pixels of the area, each tap a
// read-only load of the pre-CDEF snapshot behind the edge tests, the
// offset tables in constant memory.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_cdef_host and rav1d_cdef_frame_host walk the same blocks
// with the same step functions, thread by thread, each barrier a loop
// boundary.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CD_HD __host__ __device__ __forceinline__
#define CD_CONST __constant__
#define CD_UNROLL _Pragma("unroll")
#else
#define CD_HD static inline
#define CD_CONST static const
#define CD_UNROLL
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

CD_HD int cd_min(int a, int b) { return a < b ? a : b; }

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

// ---------------------------------------------------------------------------
// rav1d_cdef: the area and its halo in shared memory
// ---------------------------------------------------------------------------

enum {
    CA_THREADS = 256,
    CA_YR = 68,        // the luma tile's rows: 64 + 2 + 2
    CA_YP = 72,        // its pitch (8 mod 32: the 4 rows of 8 pixels a warp
                       // filters of a unit fall on distinct banks)
    CA_DP = 65,        // words per unit of the direction search's copy
    CA_FLAGS = 5,      // any[0]: a strength; [1]: a luma one; [2]: a chroma one;
                       // [3], [4]: the luma, chroma units that filter
    CA_OFFS = 2 * 8 * 6,
    CA_BATCH = 8,      // loads a thread has in flight while staging
};
// per unit, in shared memory: [field][unit]; A = pri | sec << 16 (0: the
// unit keeps its pixels), per plane kind (Y, UV)
enum {
    CA_LY, CA_LUV, CA_NEED,
    CA_YA, CA_YDIR, CA_YTAP, CA_YPSH, CA_YSSH,
    CA_UA, CA_UDIR, CA_UTAP, CA_UPSH, CA_USSH,
    CA_N
};

// (dy + 2, dx + 1) of tap k of direction d's primary ring (CD_PRI): 3 and
// 2 bits at entry 2d + k; the secondary rings are the primary rings of
// directions d + 2 and d - 2 (CD_SEC1, CD_SEC2). 4:2:2's chroma
// direction of luma direction d (CD_UV_DIRS[1]): 4 bits at entry d.
#define CA_DY 0x8e38e3692281ull
#define CA_DX 0x159eeeeeu
#define CA_UV422 0x66654207u

CD_HD int ca_dy(int d, int k) { return (int)((CA_DY >> (3 * (2 * d + k))) & 7) - 2; }
CD_HD int ca_dx(int d, int k) { return (int)((CA_DX >> (2 * (2 * d + k))) & 3) - 1; }

// the word offset of offset j of direction d at a pitch: j = 0, 1 the
// primary taps, 2, 3 the first secondary ring's, 4, 5 the second's
CD_HD int ca_off(int d, int j, int pitch) {
    const int dd = j < 2 ? d : (j < 4 ? d + 2 : d + 6) & 7, k = j & 1;
    return ca_dy(dd, k) * pitch + ca_dx(dd, k);
}

// the planes cover the unit grid (as the plain pass needs them to)
CD_HD bool ca_ok(const CdefFrame& p) {
    return cd_ok(p) && p.damping >= 0 && p.damping < 1 << 12 && p.ah >= 8 * p.nby &&
           p.aw >= 8 * p.nbx;
}

// The shared words of a block, by part.
struct CaSmem {
    int yt, ct, dp, cost, u, list, off, any, total;
};

// a chroma tile's pitch (36 or 72: a unit's rows of 4 or 8 pixels on
// distinct banks) and rows
CD_HD int ca_cpitch(const CdefFrame& p) { return p.ss_hor ? 36 : 72; }
CD_HD int ca_crows(const CdefFrame& p) { return (64 >> p.ss_ver) + 4; }

CD_HD CaSmem ca_smem(const CdefFrame& p) {
    CaSmem m;
    m.yt = 0;
    m.ct = CA_YR * CA_YP;
    m.dp = m.ct + (p.uv422 >= 0 ? 2 * ca_crows(p) * ca_cpitch(p) : 0);
    m.cost = m.dp + 64 * CA_DP;
    m.u = m.cost + 64 * 8;
    m.list = m.u + CA_N * 64;
    m.off = m.list + 2 * 64;
    m.any = m.off + CA_OFFS;
    m.total = m.any + CA_FLAGS;
    return m;
}

// One block's area and its shared buffers.
struct CaBlk {
    int by0, bx0;       // the area's first unit
    int* yt;            // luma tile: 68 rows of CA_YP words, (r, c) = plane (8 by0 - 2 + r, 8 bx0 - 2 + c)
    int* ct;            // chroma tiles, ca_crows rows of ca_cpitch words each, from (ch by0 - 2,
                        // cw bx0 - 2); the second one csz words on
    int csz;
    int* dp;            // the direction search's luma, CA_DP words per unit
    unsigned* cost;     // 8 direction costs per unit
    int* u;             // per unit: [field][unit]
    int* list;          // the units that filter: [kind (luma, chroma)][any[3 + kind]]
    int* off;           // tap offsets: [kind][direction][6]
    int* any;
};

CD_HD CaBlk ca_block(const CdefFrame& p, int bx0, int by0, int* sm) {
    const CaSmem m = ca_smem(p);
    CaBlk b;
    b.by0 = by0;
    b.bx0 = bx0;
    b.yt = sm + m.yt;
    b.ct = sm + m.ct;
    b.csz = ca_crows(p) * ca_cpitch(p);
    b.dp = sm + m.dp;
    b.cost = (unsigned*)(sm + m.cost);
    b.u = sm + m.u;
    b.list = sm + m.list;
    b.off = sm + m.off;
    b.any = sm + m.any;
    return b;
}

// step 0: the flags cleared
CD_HD void ca_init(const CaBlk& b, int t) {
    if (t < CA_FLAGS) b.any[t] = 0;
}

// step 1: the units' level bytes (thread t < 64 takes unit t) and whether
// each needs a direction (the luma primary strength or, with chroma, the
// chroma one); the luma tile is staged for a luma strength or a direction,
// the chroma tiles for a chroma strength
CD_HD void ca_levels(const CdefFrame& p, const CaBlk& b, int t) {
    if (t >= 64) return;
    const int by = b.by0 + (t >> 3), bx = b.bx0 + (t & 7);
    int yl = 0, ul = 0;
    if (by < p.nby && bx < p.nbx) {
        yl = ((const unsigned char*)(p.blob + p.ylvl))[(size_t)by * p.nbx + bx];
        if (p.uv422 >= 0) ul = ((const unsigned char*)(p.blob + p.uvlvl))[(size_t)by * p.nbx + bx];
    }
    b.u[CA_LY * 64 + t] = yl;
    b.u[CA_LUV * 64 + t] = ul;
    const bool need = (yl >> 2) > 0 || (ul >> 2) > 0;
    b.u[CA_NEED * 64 + t] = need;
    if (yl | ul) b.any[0] = 1;
    if (yl || need) b.any[1] = 1;
    if (ul) b.any[2] = 1;
}

// step 2: the tiles (a luma word for item i < 68 * 68, then the chroma
// tiles' words, CW = 8 cw + 4 a row): MISSING outside the plane and past
// the frame's last unit row and column; a row across neighbouring
// threads, CA_BATCH plane words a thread in flight together (every one
// read before any is written); and the tap offsets
template <int CW>
CD_HD void ca_stage(const CdefFrame& p, const CaBlk& b, int t) {
    const size_t psz = (size_t)p.ah * p.aw;
    const int ch = 8 >> p.ss_ver, cw = 8 >> p.ss_hor, crows = ca_crows(p), cp = ca_cpitch(p);
    const int ny = b.any[1] ? 68 * 68 : 0, nc = b.any[2] ? crows * CW : 0, n = ny + 2 * nc;
    for (int i0 = t; i0 < n; i0 += CA_THREADS * CA_BATCH) {
        int v[CA_BATCH], at[CA_BATCH];
        CD_UNROLL
        for (int u = 0; u < CA_BATCH; u++) {
            const int i = i0 + u * CA_THREADS;
            int y, x, ylim, xlim;
            const int* src;
            if (i < ny) {  // luma
                y = 8 * b.by0 - 2 + i / 68;
                x = 8 * b.bx0 - 2 + i % 68;
                ylim = 8 * p.nby;
                xlim = 8 * p.nbx;
                src = p.pre;
                at[u] = i / 68 * CA_YP + i % 68;
            } else {  // chroma plane pl
                const int pl = i - ny >= nc, c = i - ny - pl * nc;
                y = ch * b.by0 - 2 + c / CW;
                x = cw * b.bx0 - 2 + c % CW;
                ylim = ch * p.nby;
                xlim = cw * p.nbx;
                src = p.pre + (pl + 1) * psz;
                at[u] = (int)(b.ct - b.yt) + pl * b.csz + c / CW * cp + c % CW;
            }
            v[u] = i < n && y >= 0 && y < ylim && x >= 0 && x < xlim
                       ? cd_ld(src + (size_t)y * p.aw + x)
                       : CD_MISSING;
        }
        CD_UNROLL
        for (int u = 0; u < CA_BATCH; u++)
            if (i0 + u * CA_THREADS < n) b.yt[at[u]] = v[u];
    }
    if (t < CA_OFFS) {
        const int kind = t / 48, d = t % 48 / 6, j = t % 6;
        b.off[t] = ca_off(d, j, kind ? ca_cpitch(p) : CA_YP);
    }
}

// step 3: the direction search's luma of each unit that needs one, biased,
// from the luma tile (the plain version clamps its reads to the plane,
// which covers every unit)
CD_HD void ca_dircopy(const CdefFrame& p, const CaBlk& b, int t) {
    const int bd = p.bpc - 8;
    for (int i = t; i < 64 * 64; i += CA_THREADS) {
        const int y = i >> 6, x = i & 63, k = (y >> 3) * 8 + (x >> 3);
        if (b.u[CA_NEED * 64 + k])
            b.dp[k * CA_DP + (y & 7) * 8 + (x & 7)] = (b.yt[(y + 2) * CA_YP + x + 2] >> bd) - 128;
    }
}

// the bin of pixel (y, x) in cost K's line sums (ops/cdef.py _fd_bins)
template <int K>
CD_HD int ca_bin(int y, int x) {
    return K == 0   ? y + x
           : K == 1 ? y + (x >> 1)
           : K == 2 ? y
           : K == 3 ? 3 + y - (x >> 1)
           : K == 4 ? 7 + y - x
           : K == 5 ? 3 - (y >> 1) + x
           : K == 6 ? x
                    : (y >> 1) + x;
}

// cost K from its line sums, in uint32 (it wraps as the plain version's
// int32 sums do)
template <int K>
CD_HD unsigned ca_fold(const int* s) {
    unsigned c = 0;
    if (K == 2 || K == 6) {
        CD_UNROLL
        for (int k = 0; k < 8; k++) c += cd_sq(s[k]);
        return c * 105u;
    }
    if (K == 0 || K == 4) {
        const unsigned div[7] = {840, 420, 280, 210, 168, 140, 120};
        c = cd_sq(s[7]) * 105u;
        CD_UNROLL
        for (int k = 0; k < 7; k++) c += (cd_sq(s[k]) + cd_sq(s[14 - k])) * div[k];
        return c;
    }
    const unsigned d135[3] = {420, 210, 140};
    CD_UNROLL
    for (int j = 3; j < 8; j++) c += cd_sq(s[j]);
    c *= 105u;
    CD_UNROLL
    for (int j = 0; j < 3; j++) c += (cd_sq(s[j]) + cd_sq(s[10 - j])) * d135[j];
    return c;
}

// costs K0 and K1 of a unit's 64 biased luma words
template <int K0, int K1>
CD_HD void ca_cost2(const int* px, unsigned* cost) {
    int s0[15], s1[15];
    CD_UNROLL
    for (int k = 0; k < 15; k++) s0[k] = s1[k] = 0;
    CD_UNROLL
    for (int i = 0; i < 64; i++) {
        const int v = px[i];
        s0[ca_bin<K0>(i >> 3, i & 7)] += v;
        s1[ca_bin<K1>(i >> 3, i & 7)] += v;
    }
    cost[K0] = ca_fold<K0>(s0);
    cost[K1] = ca_fold<K1>(s1);
}

// step 4: warp w takes units 32 (w >> 2) .. + 31, lane = unit, and the
// cost pair w & 3 (the same across the warp)
CD_HD void ca_dirs(const CaBlk& b, int t) {
    const int w = t >> 5, u = (w >> 2) * 32 + (t & 31);
    if (!b.u[CA_NEED * 64 + u]) return;
    const int* px = b.dp + u * CA_DP;
    unsigned* cost = b.cost + 8 * u;
    switch (w & 3) {
        case 0: ca_cost2<2, 6>(px, cost); break;
        case 1: ca_cost2<0, 4>(px, cost); break;
        case 2: ca_cost2<1, 3>(px, cost); break;
        default: ca_cost2<5, 7>(px, cost); break;
    }
}

// a shift amount as cd_sar takes it, for a plain >>: one outside 0..31
// becomes 31 (a >> 31 fills with the sign, as cd_sar does)
CD_HD int ca_shift(int s) { return (unsigned)s > 31u ? 31 : s; }

// a plane kind's strengths into the unit's fields at f (CA_YA or CA_UA)
CD_HD void ca_put(const CaBlk& b, int f, int k, int pri, int sec, int dir, int damping, int bd) {
    b.u[f * 64 + k] = pri | sec << 16;
    b.u[(f + 1) * 64 + k] = dir;
    b.u[(f + 2) * 64 + k] = 4 - ((pri >> bd) & 1);
    const int psh = damping - (pri > 0 ? cd_ulog2(pri) : 0);
    b.u[(f + 3) * 64 + k] = ca_shift(psh < 0 ? 0 : psh);
    b.u[(f + 4) * 64 + k] = ca_shift(damping - (sec > 0 ? cd_ulog2(sec) : 0));
}

// cd_constrain with a shift amount from ca_shift
CD_HD int ca_constrain(int diff, int thr, int shift) {
    const int ad = diff < 0 ? -diff : diff;
    int v = thr - (ad >> shift);
    v = v < 0 ? 0 : v;
    v = ad < v ? ad : v;
    return diff < 0 ? -v : v;
}

// a list's next slot
CD_HD int ca_slot(int* n) {
#ifdef __CUDA_ARCH__
    return atomicAdd(n, 1);
#else
    return (*n)++;
#endif
}

// step 5: the units' direction (the first maximum), variance and
// strengths (thread t < 64 takes unit t), and the lists of the units that
// filter
CD_HD void ca_params(const CdefFrame& p, const CaBlk& b, int t) {
    if (t >= 64) return;
    const int bd = p.bpc - 8;
    const int yl = b.u[CA_LY * 64 + t], ul = b.u[CA_LUV * 64 + t];
    int dir = 0, var = 0;
    if (b.u[CA_NEED * 64 + t]) {
        const unsigned* c = b.cost + 8 * t;
        unsigned best = c[0];
        for (int k = 1; k < 8; k++)
            if (c[k] > best) {
                best = c[k];
                dir = k;
            }
        var = (int)((best - c[dir ^ 4]) >> 10);
    }
    // variance-adjusted primary strength (cdef.rs adjust_strength)
    const int ypri = (yl >> 2) << bd;
    const int v6 = var >> 6;
    const int lg = cd_ulog2(cd_clamp(v6, 1, 4095));
    const int i = v6 >= 4096 ? 12 : (lg < 12 ? lg : 12);
    const int adj = (ypri * (4 + i) + 8) >> 4;
    const int pri = ypri > 0 ? (var == 0 ? 0 : adj) : 0;
    const int ysec = ((yl & 3) == 3 ? 4 : (yl & 3)) << bd;
    ca_put(b, CA_YA, t, pri, ysec, ypri > 0 ? dir : 0, p.damping, bd);
    const int uvpri = (ul >> 2) << bd;
    const int uvdir = uvpri > 0 ? (p.uv422 == 1 ? (int)((CA_UV422 >> (4 * dir)) & 15) : dir) : 0;
    ca_put(b, CA_UA, t, uvpri, ((ul & 3) == 3 ? 4 : (ul & 3)) << bd, uvdir, p.damping - 1, bd);
    // the units that filter, listed (in any order) per plane kind
    for (int kind = 0; kind < 2; kind++)
        if (b.u[(kind ? CA_UA : CA_YA) * 64 + t]) b.list[kind * 64 + ca_slot(b.any + 3 + kind)] = t;
}

// The filtered pixel at tile word tp of a unit (ops/cdef.py
// cdef_filter_batch): its 12 taps at the direction's offsets `off`.
CD_HD int ca_pixel(const int* tp, const int* off, int pri, int sec, int tap, int psh, int ssh) {
    const int px = tp[0];
    const bool hp = pri > 0, hs = sec > 0, both = hp && hs;
    if (!hp && !hs) return px;
    int s = 0, mn = px, mx = px;
#define CA_TRACK(v)                                 \
    if (both) {                                     \
        if ((unsigned)(v) < (unsigned)mn) mn = (v); \
        if ((v) > mx) mx = (v);                     \
    }
    CD_UNROLL
    for (int k = 0; k < 2; k++) {
        const int p0 = tp[off[k]], p1 = tp[-off[k]];
        if (hp) s += tap * (ca_constrain(p0 - px, pri, psh) + ca_constrain(p1 - px, pri, psh));
        CA_TRACK(p0);
        CA_TRACK(p1);
        tap = (tap & 3) | 2;
        const int s0 = tp[off[2 + k]], s1 = tp[-off[2 + k]];
        const int s2 = tp[off[4 + k]], s3 = tp[-off[4 + k]];
        if (hs)
            s += (2 - k) * (ca_constrain(s0 - px, sec, ssh) + ca_constrain(s1 - px, sec, ssh) +
                            ca_constrain(s2 - px, sec, ssh) + ca_constrain(s3 - px, sec, ssh));
        CA_TRACK(s0);
        CA_TRACK(s1);
        CA_TRACK(s2);
        CA_TRACK(s3);
    }
#undef CA_TRACK
    int out = px + ((s - (s < 0) + 8) >> 4);
    if (both) {
        out = out < mx ? out : mx;
        out = out > mn ? out : mn;
    }
    return out;
}

// one plane kind's filtered pixels, unit by unit from its list: a unit of
// (1 << ush, 1 << usw) pixels whose (0, 0) is plane (y0, x0) + its
// position times the unit size; f the kind's fields, tile its tile (pitch
// tpitch), off its offsets. Neighbouring threads take neighbouring pixels
// of one unit (a warp: 32 pixels of one unit, or two units of 16), so a
// warp's lanes share their strengths and direction.
CD_HD void ca_plane(const CdefFrame& p, const CaBlk& b, int* dst, const int* tile, int tpitch,
                    const int* off, int kind, int y0, int x0, int ush, int usw, int t) {
    const int f = kind ? CA_UA : CA_YA, lu = ush + usw;
    for (int i = t; i < b.any[3 + kind] << lu; i += CA_THREADS) {
        const int k = b.list[kind * 64 + (i >> lu)], q = i & ((1 << lu) - 1);
        const int r = ((k >> 3) << ush) + (q >> usw), c = ((k & 7) << usw) + (q & ((1 << usw) - 1));
        const int gy = y0 + r, gx = x0 + c;
        if (gy >= p.ah || gx >= p.aw) continue;
        const int a = b.u[f * 64 + k];
        dst[(size_t)gy * p.aw + gx] =
            ca_pixel(tile + (r + 2) * tpitch + c + 2, off + 6 * b.u[(f + 1) * 64 + k], a & 0xffff,
                     a >> 16, b.u[(f + 2) * 64 + k], b.u[(f + 3) * 64 + k], b.u[(f + 4) * 64 + k]);
    }
}

// step 6: the listed units' pixels, luma then the chroma planes
CD_HD void ca_filter(const CdefFrame& p, const CaBlk& b, int t) {
    ca_plane(p, b, p.planes, b.yt, CA_YP, b.off, 0, 8 * b.by0, 8 * b.bx0, 3, 3, t);
    if (p.uv422 < 0) return;
    const size_t psz = (size_t)p.ah * p.aw;
    for (int pl = 0; pl < 2; pl++)
        ca_plane(p, b, p.planes + (pl + 1) * psz, b.ct + pl * b.csz, ca_cpitch(p), b.off + 48, 1,
                 (8 >> p.ss_ver) * b.by0, (8 >> p.ss_hor) * b.bx0, 3 - p.ss_ver, 3 - p.ss_hor, t);
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

// 4 blocks an SM (64 registers a thread), as many as a 4:2:0 block's
// shared memory allows
__global__ void __launch_bounds__(CA_THREADS, 4) cdef_area_kernel(const __grid_constant__ CdefFrame p) {
    extern __shared__ int ca_sm[];
    const CaBlk b = ca_block(p, blockIdx.x * 8, blockIdx.y * 8, ca_sm);
    const int t = threadIdx.x;
    ca_init(b, t);
    __syncthreads();
    ca_levels(p, b, t);
    __syncthreads();
    if (!b.any[0]) return;  // the same for every thread of the block
    if (p.ss_hor)
        ca_stage<36>(p, b, t);
    else
        ca_stage<68>(p, b, t);
    __syncthreads();
    ca_dircopy(p, b, t);
    __syncthreads();
    ca_dirs(b, t);
    __syncthreads();
    ca_params(p, b, t);
    __syncthreads();
    ca_filter(p, b, t);
}

// Plain C entry (bound with ctypes): one launch over the frame's units on
// `stream`. Returns the launch's error code (-1 for arguments the kernel
// does not take).
extern "C" int rav1d_cdef(const CdefFrame* f, void* stream) {
    if (!ca_ok(*f)) return -1;
    if (f->nby <= 0 || f->nbx <= 0) return 0;
    const int smem = ca_smem(*f).total * (int)sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(cdef_area_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((f->nbx + 7) / 8, (f->nby + 7) / 8);
    cdef_area_kernel<<<grid, CA_THREADS, smem, (cudaStream_t)stream>>>(*f);
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

#include <vector>

// rav1d_cdef without the stream: every block in order, each step for
// every thread in turn. The shared words start as a pattern, so a read of
// a word no step wrote shows.
extern "C" int rav1d_cdef_host(const CdefFrame* f) {
    const CdefFrame& p = *f;
    if (!ca_ok(p)) return -1;
    std::vector<int> sm(ca_smem(p).total);
    for (int by0 = 0; by0 < p.nby; by0 += 8)
        for (int bx0 = 0; bx0 < p.nbx; bx0 += 8) {
            for (int& w : sm) w = 0x5a5a5a5a;
            const CaBlk b = ca_block(p, bx0, by0, sm.data());
            for (int t = 0; t < CA_THREADS; t++) ca_init(b, t);
            for (int t = 0; t < CA_THREADS; t++) ca_levels(p, b, t);
            if (!b.any[0]) continue;
            for (int t = 0; t < CA_THREADS; t++)
                if (p.ss_hor)
                    ca_stage<36>(p, b, t);
                else
                    ca_stage<68>(p, b, t);
            for (int t = 0; t < CA_THREADS; t++) ca_dircopy(p, b, t);
            for (int t = 0; t < CA_THREADS; t++) ca_dirs(b, t);
            for (int t = 0; t < CA_THREADS; t++) ca_params(p, b, t);
            for (int t = 0; t < CA_THREADS; t++) ca_filter(p, b, t);
        }
    return 0;
}

// rav1d_cdef's tables as rav1d_cdef_tables_host lays out the constant
// ones: (dy, dx) of CD_PRI, CD_SEC1, CD_SEC2 (from the word offsets at a
// pitch of 100), then CD_UV_DIRS (112 ints)
extern "C" int rav1d_cdef_area_tables_host(int* out) {
    int n = 0;
    for (int ring = 0; ring < 3; ring++)
        for (int d = 0; d < 8; d++)
            for (int k = 0; k < 2; k++) {
                const int o = ca_off(d, 2 * ring + k, 100), dy = (o + 50 + 1000) / 100 - 10;
                out[n++] = dy;
                out[n++] = o - 100 * dy;
            }
    for (int d = 0; d < 8; d++) out[n++] = d;
    for (int d = 0; d < 8; d++) out[n++] = (int)((CA_UV422 >> (4 * d)) & 15);
    return n;
}

#endif  // __CUDACC__
