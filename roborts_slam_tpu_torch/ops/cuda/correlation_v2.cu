// Correlation scoring kernel, second version, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_correlation_kernel_v2` of the JAX package
// (roborts_slam_tpu/ops/pallas/correlation.py, reached through
// `accumulate_windows_v2` / `score_candidates_pallas_v2`, selected with
// ROBORTS_CORR_KERNEL=2). It computes the same function as
// `correlation_scores_kernel` (correlation.cu):
//
//   score[b,a,kx,ky] = (sum_s v(b,a,s,kx,ky)) / divisor[b]
//   v = 0                      if sample s is not a valid scan point
//     = default_prob           if the candidate cell lies outside the map
//     = probs[b, gy, gx]       otherwise
//   gx = floor(rx[b,a,s] + xs[b,kx] + 0.5),  gy = floor(ry[b,a,s] + ys[b,ky] + 0.5)
//
// What the TPU kernel adds over its first version is work shared between
// candidate windows. Its slab, lane alignment, sort and even-padding exist
// only for that machine and are not carried over. What the candidates of
// one window can share on this card is their LOADS: the N x N candidate
// cells of one sample are gx(0..N-1) x gy(0..N-1), a box of the map, and
// where the candidate step is under one map cell several candidates land on
// one cell (the real-robot profile's fine tier: 11 candidates of a window
// row on 9 cells). The first kernel reads that box once per candidate; this
// one copies it into shared memory once per sample and lets every
// candidate take its cell from the copy.
//
// What bounds it on this card: as for the first kernel, neither bytes nor
// operations but the launch and the chain of dependent loads from a map
// that sits in L2 (sample coordinates, then cells), and here the length of
// the code that one lane runs. A first design that shared the index
// arithmetic between candidates (never the limit) took 46-52 us per wrapper
// call; this one measures 5.3 us per launch on the super-fine tier, 8.4 on
// the real-robot fine tier and 11-13 on the coarse tier (`device_us` of
// chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W). What was learned on the way,
// same card: a whole warp per sample with the candidates' columns and rows
// in shared tables was bound by how fast the few SMs it used start operations
// (16-20 us); teams of lanes synchronised with sub-warp masks split their
// warp for good and ran one after the other (60 us); a box of more cells
// than candidates (21 x 21 cells for 121 reads at a step of two) doubled
// the time. And the staging itself does not pay at these sizes: with
// `stage` = 0 the same launch takes 4.2 us where it takes 5.3 and 5.5
// where it takes 8.4, because a box of 3 or 9 cells saves at most two loads
// of eleven and costs a copy, a warp barrier and a second read. It stays
// because shared loads are what this kernel is for; chip_smoke.py prints
// both times (`walk_device_us`).
//
// Design: the slices of the first kernel (P = ceil(S / L), a slice summed
// in index order, the P partial sums added in slice order through shared
// memory, no floating-point atomics), so the two kernels agree bit for bit
// and a launch repeats its bits.
//   - A block takes one (map, angle) and a group of R rows (ky) of the
//     window, so that a tier of 21 angles still gives hundreds of blocks. A
//     team of T lanes (a power of two inside one warp) takes one slice; a
//     lane owns one, two or four of the group's candidates (c = ky N + kx,
//     lanes along kx, the map's fast axis). R, T and the slots per lane are
//     chosen so that few lanes stay without a candidate.
//   - Per sample, every lane of the team forms the group's box, columns
//     gx(0)..gx(N-1) by rows gy(first)..gy(last), clipped to the map, and
//     its own candidates' cells. Where the box has no more cells than the
//     team has candidates, lane i copies cell i of it into the sample's
//     buffer, row segments with neighbouring lanes on neighbouring
//     addresses, each map cell once per sample; else each lane copies its
//     candidates' own cells. Both go through cp.async (4 bytes a copy), the
//     copies of all eight samples of a slice in flight together: one L2
//     latency per slice. TMA was not tried: its rows are multiples of 16
//     bytes at 16-byte strides, and a box row here is 12-44 bytes at any
//     column.
//   - After one warp barrier each lane adds, sample by sample, its
//     candidates' values: buffer[(cy - y_lo) * width + cx - x_lo], or its
//     own slot. A candidate outside the map adds `default_prob` and copies
//     nothing; a box wholly outside the map copies nothing; candidates on
//     one cell read one entry. xs and ys ascend in every caller, which puts
//     every candidate's cell in the box; for any other order a cell that
//     the box does not hold is read from the map where it lies.
//   - No branch between the staging and the partial sums depends on a
//     team's data, and every warp-wide operation names the whole warp, so
//     the teams of a warp run in step.
//   - A group whose window spans more cells than it has candidates (the
//     coarse tier, a fine tier of two-cell steps) never fits its box: the
//     block then walks as the first kernel does, every candidate reading
//     its own cell with all loads of a slice in flight.
//   - Slices past the last valid sample are not walked (every caller's mask
//     is a prefix); any mask is summed right.
// L, P, R, T, the slots and the teams per block are computed in Python
// (`launch_geometry` of ops/cuda/correlation.py) and passed in.
//
// Rounding: the two adds are separate round-to-nearest adds (__fadd_rn) in
// the plain version's order and the floored coordinate is compared as a
// float before the cast: the cells are the plain version's.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 512;      // V2_BLOCK_THREADS of ops/cuda/correlation.py
constexpr int kSub = 8;                 // samples a team keeps in flight
// what a (sample, candidate) adds, where it is not an entry of the buffer
constexpr int kOutside = -1;            // default_prob
constexpr int kDirect = -2;             // its cell, read from the map (not in the box)
constexpr int kNothing = -3;            // 0: the sample is not valid

// floor(coord + offset + 0.5) as the plain version forms it: two separate
// round-to-nearest adds, which nvcc may not contract or reorder
__device__ __forceinline__ float cell_of(float coord, float offset)
{
    return floorf(__fadd_rn(__fadd_rn(coord, offset), 0.5f));
}

template <int kSlots>                   // candidates per lane: 1, 2 or 4
__global__ void __launch_bounds__(kBlockThreads, 2) correlation_scores_v2_kernel(
    const float* __restrict__ probs,            // (B, H, W)
    const float* __restrict__ rx,               // (B, A, S)
    const float* __restrict__ ry,               // (B, A, S)
    const unsigned char* __restrict__ svalid,   // (B, S)
    const float* __restrict__ xs,               // (B, N)
    const float* __restrict__ ys,               // (B, N)
    const float* __restrict__ divisor,          // (B,)
    float* __restrict__ scores,                 // (B, A, N, N)
    int A, int S, int N, int H, int W,
    int L,          // samples per slice
    int P,          // slices: ceil(S / L)
    int G,          // row groups per (map, angle)
    int R,          // window rows (ky) per group
    int T,          // lanes per team: 1, 2, 4, 8, 16 or 32
    int stage,      // 0: never stage a box (for measurements: the walk alone)
    float default_prob)
{
    extern __shared__ float smem[];
    const int NT = blockDim.x / T;              // teams in this block (whole warps)
    const int team = threadIdx.x / T;
    const int lane = threadIdx.x % T;
    const int chunk = kSlots * T;               // candidates per pass; floats per buffer
    const int ba = blockIdx.x / G;
    const int b = ba / A;
    const int ky0 = (blockIdx.x % G) * R;       // this block's rows of the window
    const int rows = min(R, N - ky0);
    const int gcand = rows * N;                 // this block's candidates

    float* srx = smem;                                   // S
    float* sry = srx + S;                                // S
    float* part = sry + S;                               // P * chunk, [slice][candidate]
    float* buf = part + P * chunk + team * kSub * chunk; // this team's kSub buffers
    unsigned char* sval = reinterpret_cast<unsigned char*>(
        part + P * chunk + NT * kSub * chunk);           // S

    // the slices worth walking: those up to the last valid sample (every
    // caller's mask is a prefix; any mask is summed right)
    __shared__ int n_used;
    if (threadIdx.x == 0) n_used = 0;
    __syncthreads();
    const size_t row = static_cast<size_t>(ba) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        srx[s] = rx[row + s];
        sry[s] = ry[row + s];
        sval[s] = svalid[static_cast<size_t>(b) * S + s];
        if (sval[s]) atomicMax(&n_used, s + 1);
    }
    __syncthreads();
    const int P_used = (n_used + L - 1) / L;

    const float* map = probs + static_cast<size_t>(b) * H * W;
    const float* bxs = xs + static_cast<size_t>(b) * N;
    const float* bys = ys + static_cast<size_t>(b) * N + ky0;
    const float fW = static_cast<float>(W);
    const float fH = static_cast<float>(H);
    // the window's first and last column, the group's first and last row
    const float x_first = bxs[0], x_last = bxs[N - 1];
    const float y_first = bys[0], y_last = bys[rows - 1];

    // From here to the partial sums no branch depends on a team's data and
    // every warp-wide operation names the whole warp: the teams of a warp
    // run in step, each on its own slice (a sub-warp mask would split the
    // warp for good and run its teams one after the other). A team with no
    // slice left walks the last one again and writes nothing.
    const int rounds = (P_used + NT - 1) / NT;
    for (int c0 = 0; c0 < gcand; c0 += chunk) {
        const int ncand = min(chunk, gcand - c0);
        float cxk[kSlots], cyk[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            // a lane without a candidate in this slot shadows candidate c0
            const int c = c0 + (lane + T * k < ncand ? lane + T * k : 0);
            cxk[k] = bxs[c % N];
            cyk[k] = bys[c / N];
        }
        // A window that spans more cells than it has candidates (the coarse
        // tier, a fine tier of two-cell steps) never fits its box, unless the
        // map's edge clips it: then nothing is staged. The same for the
        // whole block, and either way gives the same cells.
        const float span_x = fmaxf(floorf(x_last - x_first), 1.0f);
        const float span_y = fmaxf(floorf(y_last - y_first), 1.0f);
        const bool never_boxed = !stage || span_x * span_y > static_cast<float>(ncand);
        for (int round = 0; round < rounds; ++round) {
            const int p = min(team + round * NT, P_used - 1);
            const bool live = team + round * NT < P_used;
            const int s0 = p * L;
            const int s1 = min(S, s0 + L);
            float acc[kSlots];
#pragma unroll
            for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
            if (never_boxed) {
                // the first kernel's walk: every candidate reads its own cell
#pragma unroll
                for (int k = 0; k < kSlots; ++k) {
#pragma unroll 8
                    for (int s = s0; s < s1; ++s) {
                        const float fx = cell_of(srx[s], cxk[k]);
                        const float fy = cell_of(sry[s], cyk[k]);
                        const bool valid = sval[s] != 0;
                        const bool inside = fx >= 0.0f && fx < fW && fy >= 0.0f && fy < fH;
                        const size_t cell = (valid && inside)
                            ? static_cast<size_t>(static_cast<int>(fy)) * W + static_cast<int>(fx)
                            : 0;
                        const float m = __ldg(map + cell);
                        acc[k] = __fadd_rn(acc[k], valid ? (inside ? m : default_prob) : 0.0f);
                    }
                }
            }
            for (int sb = s0; !never_boxed && sb < s0 + L; sb += kSub) {
                // 1: per sample, the box of the group's window and the copies
                // into the sample's buffer; all kSub samples' copies are in
                // flight together. Slot i = lane + T k takes cell i of the
                // box, or the cell of the lane's k-th candidate.
                int idx[kSub][kSlots];
#pragma unroll
                for (int j = 0; j < kSub; ++j) {
                    const int s = min(sb + j, S - 1);
                    const bool active = sb + j < s1 && sval[s] != 0;
                    const float sx = srx[s], sy = sry[s];
                    // clipped to the map as floats: the cast of a huge value
                    // is undefined
                    const float bx0 = fmaxf(cell_of(sx, x_first), 0.0f);
                    const float bx1 = fminf(cell_of(sx, x_last), fW - 1.0f);
                    const float by0 = fmaxf(cell_of(sy, y_first), 0.0f);
                    const float by1 = fminf(cell_of(sy, y_last), fH - 1.0f);
                    const bool some = active && bx0 <= bx1 && by0 <= by1;
                    const int x_lo = some ? static_cast<int>(bx0) : 0;
                    const int y_lo = some ? static_cast<int>(by0) : 0;
                    const int w = some ? static_cast<int>(bx1) - x_lo + 1 : 1;
                    const int h = some ? static_cast<int>(by1) - y_lo + 1 : 0;
                    // copied as a box where it has no more cells than the
                    // pass has candidates (also where it has none)
                    const bool boxed = static_cast<long long>(w) * h <= ncand;
                    const int cells = boxed ? w * h : 0;
                    // i / w for i < 128: the quotient of a half-integer by
                    // w is never within rounding of an integer
                    const float inv_w = 1.0f / static_cast<float>(w);
#pragma unroll
                    for (int k = 0; k < kSlots; ++k) {
                        const int i = lane + T * k;
                        const float fx = cell_of(sx, cxk[k]);
                        const float fy = cell_of(sy, cyk[k]);
                        const bool inside = fx >= 0.0f && fx < fW && fy >= 0.0f && fy < fH;
                        const int cx = inside ? static_cast<int>(fx) : 0;
                        const int cy = inside ? static_cast<int>(fy) : 0;
                        // ascending xs, ys put every candidate's cell in the
                        // box; for others the cell is read where it lies
                        const bool in_box = cx >= x_lo && cx < x_lo + w
                            && cy >= y_lo && cy < y_lo + h;
                        const int r = static_cast<int>((static_cast<float>(i) + 0.5f) * inv_w);
                        const bool wanted = boxed ? i < cells : (active && inside);
                        const int gx = boxed ? x_lo + i - r * w : cx;
                        const int gy = boxed ? y_lo + r : cy;
                        if (wanted)
                            __pipeline_memcpy_async(
                                buf + j * chunk + i,
                                map + static_cast<size_t>(gy) * W + gx, sizeof(float));
                        idx[j][k] = !active ? kNothing
                            : !inside ? kOutside
                            : !boxed ? i
                            : in_box ? (cy - y_lo) * w + cx - x_lo
                            : kDirect;
                    }
                }
                __pipeline_commit();
                __pipeline_wait_prior(0);
                __syncwarp();            // every lane's copies have landed
                // 2: the sums, in sample order (a sample that is not valid
                // adds 0, which leaves a sum of non-negative terms as it is)
#pragma unroll
                for (int j = 0; j < kSub; ++j) {
#pragma unroll
                    for (int k = 0; k < kSlots; ++k) {
                        const int at = idx[j][k];
                        float v = at == kNothing ? 0.0f : default_prob;
                        if (at >= 0) v = buf[j * chunk + at];
                        if (at == kDirect) {
                            const int s = min(sb + j, S - 1);
                            v = __ldg(map + static_cast<size_t>(static_cast<int>(
                                    cell_of(sry[s], cyk[k]))) * W
                                + static_cast<int>(cell_of(srx[s], cxk[k])));
                        }
                        acc[k] = __fadd_rn(acc[k], v);
                    }
                }
                __syncwarp();            // done with the buffers
            }
#pragma unroll
            for (int k = 0; k < kSlots; ++k)
                if (live && lane + T * k < ncand) part[p * chunk + lane + T * k] = acc[k];
        }
        __syncthreads();
        const float div = divisor[b];
        for (int cl = threadIdx.x; cl < ncand; cl += blockDim.x) {
            float acc = 0.0f;
            for (int p = 0; p < P_used; ++p)
                acc = __fadd_rn(acc, part[p * chunk + cl]);
            const int kx = (c0 + cl) % N;
            const int ky = ky0 + (c0 + cl) / N;
            scores[(static_cast<size_t>(ba) * N + kx) * N + ky] = __fdiv_rn(acc, div);
        }
        __syncthreads();                 // `part` is free for the next chunk
    }
}

}  // namespace

// `geometry` holds B, A, S, N, H, W, L, P, G, R, T, the slots per lane (1, 2
// or 4), the teams per block (whole warps: T * teams is a multiple of 32),
// the shared bytes and `stage`, in that order, as the caller computed them
// (one pointer instead of fifteen integers: the call is cheaper to make
// from Python). Returns cudaGetLastError().
extern "C" int correlation_scores_v2_launch(
    const float* probs, const float* rx, const float* ry,
    const unsigned char* svalid, const float* xs, const float* ys,
    const float* divisor, float* scores,
    const int* geometry, float default_prob, void* stream)
{
    const int* g = geometry;
    const int B = g[0], A = g[1], S = g[2], N = g[3], H = g[4], W = g[5];
    const int L = g[6], P = g[7], G = g[8], R = g[9], T = g[10], slots = g[11];
    const int teams = g[12], shared_bytes = g[13], stage = g[14];
    auto kernel = slots == 1 ? correlation_scores_v2_kernel<1>
                : slots == 2 ? correlation_scores_v2_kernel<2>
                             : correlation_scores_v2_kernel<4>;
    static int opted_in[3] = {48 * 1024, 48 * 1024, 48 * 1024};
    int& mine = opted_in[slots == 1 ? 0 : slots == 2 ? 1 : 2];
    if (shared_bytes > mine) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        mine = shared_bytes;
    }
    kernel<<<B * A * G, T * teams, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
        probs, rx, ry, svalid, xs, ys, divisor, scores,
        A, S, N, H, W, L, P, G, R, T, stage, default_prob);
    return static_cast<int>(cudaGetLastError());
}
