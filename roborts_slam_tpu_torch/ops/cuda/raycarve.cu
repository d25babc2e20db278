// Ray carving and ray checking kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels `_carve_kernel` and `_raycheck_kernel` of the
// JAX package (roborts_slam_tpu/ops/pallas/raycarve.py, reached through
// `scan_mark_image_pallas` and `_bad_rays_pallas`). Both walk rays with the
// exact integer DDA of the plain versions:
//
//   n = max(|dx|, |dy|, 1),  cell(t) = floor(start + delta*t/n + 1/2)
//           = start + floor_div(2*delta*t + n, 2n),   t = 0..n
//
// (2n*start is a multiple of 2n and leaves the floor division; the division
// floors: the numerator is negative for rays that run down an axis, and C++
// `/` truncates toward zero).
//
// The DDA, shared by both kernels (`Dda`): a lane that visits t0, t0 + k,
// t0 + 2k, ... divides twice per axis, once for quotient and remainder of
// its first step and once for those of 2*delta*k, and then steps with two
// adds and one carry. All of it in 32 bits where 2n^2 + 3n < 2^31
// (n <= 32767, coordinates below 2^30): a 64-bit division is a routine of
// many tens of instructions on this card. A longer ray takes the same code
// in 64 bits, decided per ray; it is exact for coordinates below 2^29, as
// far as the plain versions are.
//
// ray_mark_image: per-scan mark image (H, W) int32, 1 on each ray's free
// prefix t in [0, n-1], 2 at the endpoint t = n, occupied beats free,
// out-of-map cells dropped. The work is 40-70 thousand cell visits, all
// within the lidar's reach of the sensor, and one write of a 1.6-4 MB image.
// On this card neither sets the time: the image's bytes take 0.5-1.3 us, and
// what is left is what a launch costs (about 2 us between two kernels of a
// stream) and how many SMs share the visits. Four designs, one call of the C
// function each, `design` of the geometry array chooses (figures: see the
// end of this comment):
//
//   0, beam-major, shipped: a kernel zeroes the image with 16-byte stores
//     and lets the next kernel of the stream start at once
//     (cudaTriggerProgrammaticLaunchCompletion); the walk is launched as its
//     programmatic dependent: a warp per beam loads its beam and divides
//     while the fill still runs, waits for the fill's end
//     (cudaGridDependencySynchronize) and then visits t = lane, lane + 32,
//     ... with one atomicMax(cell, t == n ? 2 : 1) each, whose result nobody
//     reads (a reduction at the L2, nothing comes back). Of a run of valid
//     beams only the first visits t = 0, the sensor's cell that all share.
//     The beams spread over every SM, which is what the tile-major design
//     lacks.
//   1, tile-major: a block owns a tile of 32 x 32 cells in shared memory, two
//     bytes a cell ("free", "endpoint"); it zeroes the tile, then every
//     thread takes beams in turn: a beam whose start/end box meets the tile
//     enters it at the later of the two axes' entry steps (cell(t) is
//     monotone along each axis, so the first step inside a column range is
//     ceil((2n*x0 - n) / 2d)) and stores 1 into "free" until its cell leaves
//     the tile, and into "endpoint" at its end: every store writes 1, so no
//     atomic is needed and the order is free. The tile leaves with 16-byte
//     stores: one launch, no fill, no global atomic, each byte of the image
//     written once. It loses because the rays are short: the visits fall on
//     the 16-36 tiles round the sensor, so as many blocks do all the walking
//     while several hundred only read the beam list and store zeroes.
//   2, beam-major on cudaMemsetAsync: the walk of design 0 behind a memset,
//     nothing overlapped.
//   3, beam-major with a load first: cudaMemsetAsync, 16 lanes a beam, and a
//     load before each atomic that skips it where the cell already holds as
//     much: a visit then waits for the L2's answer, which the atomic alone
//     does not.
//
// bad_ray_count: number of rays per pose that visit, for t in [0, n], an
// occupied cell (passes >= min_passthrough and hits/passes >=
// occu_threshold) whose squared cell distance to the endpoint is >= thr_d2.
// The work is 100-200 rays of <= 205 steps per pose, so what is left is one
// launch and the loads' latency. Design: a warp per ray with all of the
// ray's steps in flight at once: a lane owns t = lane, lane + 32, ...,
// eight steps unrolled (256 cells, the 205 of a 10 m lidar at 0.05 m
// included), a loop of such rounds only beyond that, and one vote per round
// of 256. The integer distance test comes first and a step that fails it
// loads nothing; where it passes, both planes are loaded together (in
// mapped space nearly every cell has passes >= min_passthrough, so a
// dependent second load would be taken almost always). The probability is
// an IEEE divide (__fdiv_rn), as in the plain version. Four rays per block,
// the blocks of a pose spread over the card; a block adds (1 << 32) + its
// count to the pose's 64-bit word of a scratch array with one atomic, and
// the block that finds every other block's arrival in what the atomic
// returns stores out[b] and sets the word back to 0: one launch, no zeroed
// output, one round trip to the L2, integer adds only. `ticket = 0` in the
// parameters takes cudaMemsetAsync + atomicAdd instead (the yardstick). The
// scratch belongs to one stream at a time.
//
// Figures: NVIDIA H100 80GB HBM3, power limit 700.00 W, CUDA 12.8; us per call
// of the C function, 100 calls in one CUDA graph replayed between two events,
// the designs in turns (chip_smoke.py on real scans of 1152 beams and 43-70
// thousand ray cells, pub maps of 640^2 / 1024^2 / 896^2; the kernels before
// this design in brackets).
//   ray_mark_image, design 0: 4.2 / 4.3 / 4.0  (fill + walk: 5.2 / 5.8 / 5.5)
//                   design 1: 6.8 / 7.8 / 6.3
//                   design 2: 4.4 / 4.7 / 4.8
//                   design 3: 8.3 / 8.5 / 7.8
//   Of design 0 the fill alone takes 1.5 / 2.2 / 1.9 and with every beam
//   masked 2.3 / 3.0 / 2.7; of design 1 the zeroed tiles alone 1.6 / 2.4 / 2.2
//   and with every beam masked 2.9 / 3.9 / 3.7, so the 400-1024 blocks pay
//   1.2-1.6 us to read the beam list, and the walk, on few SMs, as much as
//   design 0's whole call (scripts/torch_ray_kernels.py, made-up scans of
//   52-80 thousand ray cells). Also built and measured slower than design 2
//   at every map, and removed: fill, a barrier of the whole grid and walk in
//   one cooperative launch; fill blocks and walking blocks in one launch, the
//   walkers waiting for a count of finished fill blocks; tiles shared by the
//   blocks of a thread block cluster through distributed shared memory.
//   bad_ray_count, B = 1 and 4, 100 rays a pose: 3.5-3.6  (zeroing + walk:
//   7.2); with cudaMemsetAsync + atomicAdd 5.7-5.9.
//   ptxas: walk 40 registers, fill 12, tiles 58 (2 KB shared), check 72; no
//   spills.

#include <cuda_runtime.h>
#include <stdint.h>

// The ray check's scalars, filled by the wrapper (a type of the C interface:
// outside the unnamed namespace, or the function that takes it loses its
// external linkage).
struct CheckParams {
    int B, S, H, W;
    int groups;            // blocks per pose: ceil(S / kCheckWarps)
    int ticket;            // 1: one packed atomic per block; 0: memset + atomicAdd
    int thr_d2;
    float min_passthrough, occu_threshold;
};

namespace {

constexpr int kNarrowMaxN = 32767;          // 2n^2 + 3n < 2^31
constexpr int kNarrowMaxCoord = 1 << 30;
constexpr int kBeamThreads = 128;
constexpr int kFillThreads = 256;
constexpr int kFillBlocks = 1024;           // resident together: all start at once
constexpr int kCheckWarps = 4;              // rays per block of the check
constexpr int kCheckRounds = 8;             // steps a lane keeps in flight

template <typename I>
__device__ __forceinline__ void floor_divmod(I a, I b, I& q, I& r) {
    // b > 0
    q = a / b;
    r = a - q * b;
    if (r < 0) { --q; r += b; }
}

template <typename I>
__device__ __forceinline__ I floor_div(I a, I b) {
    I q, r;
    floor_divmod<I>(a, b, q, r);
    return q;
}

__device__ __forceinline__ bool is_narrow(int sx, int sy, int ex, int ey) {
    const long long dx = (long long)ex - sx, dy = (long long)ey - sy;
    const long long n = max(dx < 0 ? -dx : dx, dy < 0 ? -dy : dy);
    const int c = kNarrowMaxCoord;
    return n <= kNarrowMaxN && sx > -c && sx < c && sy > -c && sy < c &&
           ex > -c && ex < c && ey > -c && ey < c;
}

// cell(t) - start along one axis, floor((2*d*t + n) / 2n), at
// t = t0, t0 + stride, ...: q is the cell offset, r the remainder
template <typename I>
struct Dda {
    I q, r, dq, dr, m;
    __device__ __forceinline__ Dda(I d, I n, I t0, I stride) {
        m = 2 * n;
        floor_divmod<I>(2 * d * t0 + n, m, q, r);
        floor_divmod<I>(2 * d * stride, m, dq, dr);
    }
    // stride 1: |d| <= n, so 2d / 2n floors to -1, 0 or 1; and at t0 = 0 the
    // offset is 0 with remainder n: a walk from the start divides nothing
    __device__ __forceinline__ Dda(I d, I n, I t0) {
        m = 2 * n;
        if (t0 == 0) { q = 0; r = n; }
        else floor_divmod<I>(2 * d * t0 + n, m, q, r);
        dq = d < 0 ? -1 : (d == n ? 1 : 0);
        dr = 2 * d - dq * m;
    }
    __device__ __forceinline__ void step() {
        q += dq;
        r += dr;
        if (r >= m) { r -= m; ++q; }
    }
};

// The first step t >= 0 whose cell offset along one axis lies in [lo, hi]
// (offsets from the start cell; the offset is monotone in t): false if no
// step of the ray does. d = 0 keeps the offset at 0.
template <typename I>
__device__ __forceinline__ bool axis_entry(I d, I n, I lo, I hi, I& t_lo) {
    const I x0 = max(lo, min(d, (I)0)), x1 = min(hi, max(d, (I)0));
    if (x0 > x1) return false;
    t_lo = 0;
    if (d == 0) return true;
    // d > 0: 2*d*t + n >= 2n*x0;  d < 0: 2*d*t + n <= 2n*x1 + 2n - 1
    const I m = 2 * n;
    const I least = d > 0 ? m * x0 - n : -(m * x1 + n - 1);   // <= 2*|d|*t
    const I den = d > 0 ? 2 * d : -2 * d;
    if (least > 0) t_lo = floor_div<I>(least + den - 1, den);
    return true;
}

// One beam inside the tile of TH x TW cells whose corner is (x0, y0). A cell
// of the tile is two bytes, "free" and "endpoint": a store writes 1 into one
// of them, so stores need no order and no atomic. The steps inside a tile are
// one run (both offsets are monotone): the walk starts at the later of the
// two axes' entries and ends where the cell leaves the tile or the free
// prefix ends. Cells of a tile beyond the map's edge are marked and never
// stored.
template <typename I, int TH, int TW>
__device__ __forceinline__ void mark_beam_in_tile(
    unsigned char* tile, I sx, I sy, I ex, I ey, I x0, I y0)
{
    const I lex = ex - x0, ley = ey - y0;
    if (lex >= 0 && lex < TW && ley >= 0 && ley < TH)
        tile[2 * ((int)ley * TW + (int)lex) + 1] = 1;
    const I dx = ex - sx, dy = ey - sy;
    const I n = max(max(dx < 0 ? -dx : dx, dy < 0 ? -dy : dy), (I)1);
    I tx, ty;
    if (!axis_entry<I>(dx, n, x0 - sx, x0 + TW - 1 - sx, tx)) return;
    if (!axis_entry<I>(dy, n, y0 - sy, y0 + TH - 1 - sy, ty)) return;
    const I t_lo = max(tx, ty);
    Dda<I> X(dx, n, t_lo), Y(dy, n, t_lo);
    const I ox = sx - x0, oy = sy - y0;
    for (I t = t_lo; t < n; ++t) {
        const I lx = ox + X.q, ly = oy + Y.q;
        if (lx < 0 || lx >= TW || ly < 0 || ly >= TH) break;
        tile[2 * ((int)ly * TW + (int)lx)] = 1;
        X.step();
        Y.step();
    }
}

// A block owns the tile at (blockIdx.x, blockIdx.y): zeroes it in shared
// memory, marks it with every beam whose start/end box meets it (a thread a
// beam), and stores it.
template <int TH, int TW, int NT>
__global__ void __launch_bounds__(NT) ray_mark_tiles_kernel(
    const int* __restrict__ start,               // (2,) [x, y]
    const int* __restrict__ end,                 // (P, 2)
    const unsigned char* __restrict__ beam_mask, // (P,)
    int P, int H, int W, int wide_stores,
    int* __restrict__ mark)                      // (H, W), every cell written
{
    __shared__ __align__(16) unsigned char tile[TH * TW * 2];
    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int x1 = x0 + TW - 1, y1 = y0 + TH - 1;
    for (int i = tid; i < TH * TW * 2 / 16; i += NT)
        reinterpret_cast<int4*>(tile)[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const int sx = start[0], sy = start[1];
    for (int p = tid; p < P; p += NT) {
        const int ex = end[2 * p], ey = end[2 * p + 1];
        if (!beam_mask[p] || min(sx, ex) > x1 || max(sx, ex) < x0 ||
            min(sy, ey) > y1 || max(sy, ey) < y0)
            continue;
        if (is_narrow(sx, sy, ex, ey))
            mark_beam_in_tile<int, TH, TW>(tile, sx, sy, ex, ey, x0, y0);
        else
            mark_beam_in_tile<long long, TH, TW>(tile, sx, sy, ex, ey, x0, y0);
    }
    __syncthreads();
    // four cells a thread: 8 bytes of the tile into 16 of the image
    for (int i = tid; i < TH * TW / 4; i += NT) {
        const int y = y0 + i / (TW / 4), x = x0 + 4 * (i % (TW / 4));
        if (y >= H || x >= W) continue;
        const uint2 two = reinterpret_cast<const uint2*>(tile)[i];
        const unsigned h[4] = {two.x & 0xffffu, two.x >> 16, two.y & 0xffffu, two.y >> 16};
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = (h[k] >> 8) ? 2 : (int)(h[k] & 1u);
        int* out = mark + (size_t)y * W + x;
        if (wide_stores) {
            // W is a multiple of 4: a group of four cells is inside the map or outside
            *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (x + k < W) out[k] = v[k];
        }
    }
}

// The visits of one beam by TEAM lanes that stride over its steps, into an
// image that holds 0 where nothing is marked yet. LOOK: a load before each
// atomic, which is skipped where the cell already holds as much. EARLY: the
// kernel was launched while the fill still ran, whose zeroes must have
// landed before the first atomic.
template <typename I, int TEAM, bool LOOK, bool EARLY>
__device__ __forceinline__ void beam_visits(
    I sx, I sy, I ex, I ey, int lane, bool first, int H, int W, int* mark)
{
    const I dx = ex - sx, dy = ey - sy;
    const I n = max(max(dx < 0 ? -dx : dx, dy < 0 ? -dy : dy), (I)1);
    Dda<I> X(dx, n, lane, TEAM), Y(dy, n, lane, TEAM);
    if (EARLY) cudaGridDependencySynchronize();
    for (I t = lane; t <= n; t += TEAM, X.step(), Y.step()) {
        if (t == 0 && !first) continue;
        const I cx = sx + X.q, cy = sy + Y.q;
        if (cx < 0 || cx >= W || cy < 0 || cy >= H) continue;
        int* cell = mark + (size_t)cy * W + (size_t)cx;
        const int v = t == n ? 2 : 1;
        if (!LOOK || __ldcg(cell) < v) atomicMax(cell, v);
    }
}

template <int TEAM, bool LOOK, bool EARLY>
__global__ void __launch_bounds__(kBeamThreads) ray_mark_beams_kernel(
    const int* __restrict__ start, const int* __restrict__ end,
    const unsigned char* __restrict__ beam_mask,
    int P, int H, int W,
    int* mark)                                   // (H, W), zeroed on the stream
{
    const int p = (blockIdx.x * kBeamThreads + threadIdx.x) / TEAM;
    const int lane = threadIdx.x % TEAM;
    bool walked = p < P;
    int sx = 0, sy = 0, ex = 0, ey = 0;
    bool first = false;
    if (walked) {
        // the beam's words are loaded together, whether it is walked or not
        sx = start[0], sy = start[1];
        ex = end[2 * p], ey = end[2 * p + 1];
        // t = 0 is the sensor's cell for every beam: the first beam of a run
        // of valid beams writes it for the run
        first = p == 0 || !beam_mask[p - 1];
        walked = beam_mask[p];
    }
    if (!walked) {
        // a thread with no beam waits too: this kernel must not end before
        // the fill has, or what follows on the stream could see the image unzeroed
        if (EARLY) cudaGridDependencySynchronize();
        return;
    }
    if (is_narrow(sx, sy, ex, ey))
        beam_visits<int, TEAM, LOOK, EARLY>(sx, sy, ex, ey, lane, first, H, W, mark);
    else
        beam_visits<long long, TEAM, LOOK, EARLY>(sx, sy, ex, ey, lane, first, H, W, mark);
}

// Zeroes the image; the next kernel of the stream may start while it runs.
__global__ void __launch_bounds__(kFillThreads) fill_zero_kernel(int* mark, size_t cells)
{
    cudaTriggerProgrammaticLaunchCompletion();
    const size_t thread = (size_t)blockIdx.x * kFillThreads + threadIdx.x;
    const size_t threads = (size_t)gridDim.x * kFillThreads;
    if (reinterpret_cast<uintptr_t>(mark) % 16 == 0) {
        for (size_t i = thread; i < cells / 4; i += threads)
            reinterpret_cast<int4*>(mark)[i] = make_int4(0, 0, 0, 0);
        for (size_t i = cells / 4 * 4 + thread; i < cells; i += threads) mark[i] = 0;
    } else {
        for (size_t i = thread; i < cells; i += threads) mark[i] = 0;
    }
}

// Whether a ray crosses an occupied cell at least thr_d2 (squared cells)
// from its endpoint; the whole warp calls it for one ray.
template <typename I>
__device__ __forceinline__ bool ray_is_bad(
    I sx, I sy, I ex, I ey, int lane,
    const float* __restrict__ hits, const float* __restrict__ passes,
    const CheckParams& prm)
{
    const I dx = ex - sx, dy = ey - sy;
    const I n = max(max(dx < 0 ? -dx : dx, dy < 0 ? -dy : dy), (I)1);
    const long long thr = prm.thr_d2;
    Dda<I> X(dx, n, lane, 32), Y(dy, n, lane, 32);
    for (I t0 = 0; t0 <= n; t0 += 32 * kCheckRounds) {      // uniform in the warp
        float p[kCheckRounds], h[kCheckRounds];
        unsigned looked = 0;
#pragma unroll
        for (int k = 0; k < kCheckRounds; ++k) {
            const I t = t0 + 32 * k + lane;
            const I cx = sx + X.q, cy = sy + Y.q;
            X.step();
            Y.step();
            // the distance uses the cell as it is, the occupancy is read at
            // the cell clamped into the map (as the plain version)
            const long long ddx = cx - ex, ddy = cy - ey;
            p[k] = 0.0f;
            h[k] = 0.0f;
            if (t <= n && ddx * ddx + ddy * ddy >= thr) {
                const I rx = min(max(cx, (I)0), (I)(prm.W - 1));
                const I ry = min(max(cy, (I)0), (I)(prm.H - 1));
                const size_t at = (size_t)ry * prm.W + (size_t)rx;
                p[k] = __ldg(passes + at);
                h[k] = __ldg(hits + at);
                looked |= 1u << k;
            }
        }
        bool bad = false;
#pragma unroll
        for (int k = 0; k < kCheckRounds; ++k) {
            const float prob = p[k] > 0.0f ? __fdiv_rn(h[k], fmaxf(p[k], 1e-9f)) : 0.5f;
            bad |= ((looked >> k) & 1u) && p[k] >= prm.min_passthrough &&
                   prob >= prm.occu_threshold;
        }
        if (__any_sync(0xffffffffu, bad)) return true;
    }
    return false;
}

__global__ void __launch_bounds__(32 * kCheckWarps) bad_ray_count_kernel(
    const int* __restrict__ start,               // (B, 2)
    const int* __restrict__ end,                 // (B, S, 2)
    const unsigned char* __restrict__ ray_ok,    // (B, S)
    const float* __restrict__ hits,              // (H, W)
    const float* __restrict__ passes,            // (H, W)
    const CheckParams prm,
    int* out,                                    // (B,)
    unsigned long long* tickets)                 // (>= B,), 0 between launches
{
    __shared__ int warp_bad[kCheckWarps];
    const int b = blockIdx.y, g = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int s = g * kCheckWarps + warp;
    bool bad = false;
    if (s < prm.S) {                                         // uniform in the warp
        // the ray's five words are loaded together, whether it is checked or not
        const size_t r = (size_t)b * prm.S + s;
        const int sx = start[2 * b], sy = start[2 * b + 1];
        const int ex = end[2 * r], ey = end[2 * r + 1];
        if (ray_ok[r])
            bad = is_narrow(sx, sy, ex, ey)
                ? ray_is_bad<int>(sx, sy, ex, ey, lane, hits, passes, prm)
                : ray_is_bad<long long>(sx, sy, ex, ey, lane, hits, passes, prm);
    }
    if (lane == 0) warp_bad[warp] = bad ? 1 : 0;
    __syncthreads();
    if (threadIdx.x != 0) return;
    unsigned count = 0;
    for (int w = 0; w < kCheckWarps; ++w) count += warp_bad[w];
    if (!prm.ticket) {
        if (count) atomicAdd(out + b, (int)count);
        return;
    }
    // arrivals in the high half, bad rays in the low half: the block that
    // finds every other arrival in the old value holds the pose's count
    const unsigned long long seen = atomicAdd(tickets + b, (1ull << 32) | count);
    if ((unsigned)(seen >> 32) == (unsigned)prm.groups - 1) {
        out[b] = (int)((unsigned)seen + count);
        tickets[b] = 0;
    }
}

template <int TH, int TW, int NT>
void launch_tiles(const int* start, const int* end, const unsigned char* beam_mask,
                  int P, int H, int W, int* mark, cudaStream_t stream)
{
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    const int wide = W % 4 == 0 && reinterpret_cast<uintptr_t>(mark) % 16 == 0;
    ray_mark_tiles_kernel<TH, TW, NT><<<grid, NT, 0, stream>>>(
        start, end, beam_mask, P, H, W, wide, mark);
}

// The walk behind whatever zeroed the image; EARLY: as the programmatic
// dependent of the kernel launched just before it on the stream.
template <int TEAM, bool LOOK, bool EARLY>
cudaError_t launch_beams(const int* start, const int* end, const unsigned char* beam_mask,
                         int P, int H, int W, int* mark, cudaStream_t stream)
{
    if (P <= 0) return cudaSuccess;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((P * TEAM + kBeamThreads - 1) / kBeamThreads);
    config.blockDim = dim3(kBeamThreads);
    config.stream = stream;
    cudaLaunchAttribute early;
    early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early.val.programmaticStreamSerializationAllowed = 1;
    config.attrs = &early;
    config.numAttrs = EARLY ? 1 : 0;
    return cudaLaunchKernelEx(&config, ray_mark_beams_kernel<TEAM, LOOK, EARLY>,
                              start, end, beam_mask, P, H, W, mark);
}

}  // namespace

// geometry: P, H, W, design (0..3, see the head of this file).
extern "C" int ray_mark_image_launch(
    const int* start, const int* end, const unsigned char* beam_mask,
    int* mark, const int* geometry, void* stream_)
{
    const int P = geometry[0], H = geometry[1], W = geometry[2], design = geometry[3];
    cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (H <= 0 || W <= 0) return 0;
    const size_t cells = (size_t)H * W;
    cudaError_t err = cudaSuccess;
    switch (design) {
    case 0: {
        const size_t blocks = (cells / 4 + kFillThreads) / kFillThreads;
        fill_zero_kernel<<<(unsigned)min(blocks, (size_t)kFillBlocks), kFillThreads, 0, stream>>>(
            mark, cells);
        err = launch_beams<32, false, true>(start, end, beam_mask, P, H, W, mark, stream);
        break;
    }
    case 1:
        launch_tiles<32, 32, 256>(start, end, beam_mask, P, H, W, mark, stream);
        break;
    case 2:
        err = cudaMemsetAsync(mark, 0, cells * sizeof(int), stream);
        if (err == cudaSuccess)
            err = launch_beams<32, false, false>(start, end, beam_mask, P, H, W, mark, stream);
        break;
    case 3:
        err = cudaMemsetAsync(mark, 0, cells * sizeof(int), stream);
        if (err == cudaSuccess)
            err = launch_beams<16, true, false>(start, end, beam_mask, P, H, W, mark, stream);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int bad_ray_count_launch(
    const int* start, const int* end, const unsigned char* ray_ok,
    const float* hits, const float* passes,
    int* out, unsigned long long* tickets,
    const CheckParams* params, void* stream_)
{
    const CheckParams prm = *params;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (prm.B <= 0) return 0;
    if (!prm.ticket) {
        cudaError_t err = cudaMemsetAsync(out, 0, (size_t)prm.B * sizeof(int), stream);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(prm.groups, prm.B);
    bad_ray_count_kernel<<<grid, 32 * kCheckWarps, 0, stream>>>(
        start, end, ray_ok, hits, passes, prm, out, tickets);
    return static_cast<int>(cudaGetLastError());
}
