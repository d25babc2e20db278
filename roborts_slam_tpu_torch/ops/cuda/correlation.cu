// Correlation scoring kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_correlation_kernel` of the JAX package
// (roborts_slam_tpu/ops/pallas/correlation.py, reached through
// `score_candidates_pallas`): for one search tier it computes
//
//   score[b,a,kx,ky] = (sum_s v(b,a,s,kx,ky)) / divisor[b]
//   v = 0                      if sample s is not a valid scan point
//     = default_prob           if the candidate cell lies outside the map
//     = probs[b, gy, gx]       otherwise
//   gx = floor(rx[b,a,s] + xs[b,kx] + 0.5),  gy = floor(ry[b,a,s] + ys[b,ky] + 0.5)
//
// What bounds it on this card: neither bytes nor operations. A tier is a
// data-dependent 2-D gather of 0.04-1.6 M four-byte reads out of a map that
// sits in the 50 MB L2; the distinct sectors touched are a few hundred KB,
// three orders of magnitude under what the memory rate would allow in the
// same time. What sets the time is the launch itself and the depth of the
// chain of dependent loads (sample coordinates, then the map cell). A first
// design with one thread per candidate that walked all S samples in turn ran
// 189-8181 busy threads on 132 SMs and took 400 L2 latencies in a row:
// 32-40 us per launch (NVIDIA H100 80GB HBM3, 700 W), the tier with the
// least work the slowest. This design measures 3.6 us per launch on the
// super-fine tier, 4.1 on the fine tier and 7-7.5 on the coarse tier
// (`device_us` of chip_smoke.py, same card), where the 1.6 M scattered reads
// of the coarse tier are what is left: about a launch and two dependent
// loads otherwise.
//
// Design: parallel over samples as well as over candidates, with no thread
// walking more than one slice of `L` samples (8 on every shipped tier).
//   - The sample axis is cut into P = ceil(S / L) slices. A thread owns one
//     (candidate, slice) pair: it adds its slice's samples in index order.
//     The loads of a slice do not depend on each other; the loop body is
//     free of branches (a sample that needs no map value reads cell 0 and
//     drops it), so the compiler keeps all L loads in flight at once: one
//     L2 latency per thread, not S.
//   - The P partial sums of a candidate meet in shared memory and are added
//     in slice order by one thread. No floating-point atomics: two launches
//     on the same inputs give the same bits, and the second kernel
//     (correlation_v2.cu), which uses the same slices, gives them too.
//   - The candidates of one (map, angle) are cut into G groups, one block
//     each of about 256 threads, so that a tier with 21 angles still puts
//     hundreds of blocks on the card. A group needs no second pass: it owns
//     its candidates' whole sums.
//   - Lanes run along kx (c = ky * N + kx, kx fastest). kx selects the map
//     column, the map's fast axis: on the fine and super-fine tiers the
//     neighbouring lanes of a slice read neighbouring cells of one row, a
//     few 32-byte sectors instead of N sectors from N rows.
//   - rx, ry and the validity of the (map, angle) are staged in shared
//     memory once per block. The mask may be any mask.
// L, P and the group size are computed in Python
// (`launch_geometry` of ops/cuda/correlation.py) and passed in.
//
// Rounding: `gx` is formed by two separate round-to-nearest adds
// (__fadd_rn), exactly as the plain PyTorch version forms it, so nvcc cannot
// contract the adds with neighbouring arithmetic; the floored coordinate is
// compared as a float before the cast; the sums are __fadd_rn chains (adds
// of loaded values have no multiply to fuse with, the intrinsic states the
// intent). The set of cells summed per candidate is the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;    // BLOCK_THREADS of ops/cuda/correlation.py

__global__ void __launch_bounds__(kBlockThreads) correlation_scores_kernel(
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
    int G,          // candidate groups per (map, angle)
    int CG,         // candidates per group (blockDim.x = CG * P)
    float default_prob)
{
    extern __shared__ float smem[];
    float* srx = smem;                        // S
    float* sry = srx + S;                     // S
    float* part = sry + S;                    // P * CG, [slice][candidate]
    unsigned char* sval = reinterpret_cast<unsigned char*>(part + P * CG);  // S

    const int ba = blockIdx.x / G;
    const int g = blockIdx.x % G;
    const int b = ba / A;
    const int C = N * N;
    const int cbeg = g * CG;
    const int ncand = min(CG, C - cbeg);
    const size_t row = static_cast<size_t>(ba) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        srx[s] = rx[row + s];
        sry[s] = ry[row + s];
        sval[s] = svalid[static_cast<size_t>(b) * S + s];
    }
    __syncthreads();

    const float* map = probs + static_cast<size_t>(b) * H * W;
    const float fW = static_cast<float>(W);
    const float fH = static_cast<float>(H);
    // thread = (candidate of the group, slice), candidates along the lanes
    const int cl = threadIdx.x % CG;
    const int p = threadIdx.x / CG;
    if (cl < ncand) {
        const int c = cbeg + cl;
        const float cx = xs[static_cast<size_t>(b) * N + c % N];
        const float cy = ys[static_cast<size_t>(b) * N + c / N];
        const int s0 = p * L;
        const int s1 = min(S, s0 + L);
        float acc = 0.0f;
#pragma unroll 8
        for (int s = s0; s < s1; ++s) {
            const float fx = floorf(__fadd_rn(__fadd_rn(srx[s], cx), 0.5f));
            const float fy = floorf(__fadd_rn(__fadd_rn(sry[s], cy), 0.5f));
            const bool valid = sval[s] != 0;
            // compare as floats: the cast of a huge value is undefined
            const bool inside = fx >= 0.0f && fx < fW && fy >= 0.0f && fy < fH;
            const size_t cell = (valid && inside)
                ? static_cast<size_t>(static_cast<int>(fy)) * W + static_cast<int>(fx)
                : 0;
            const float m = __ldg(map + cell);
            acc = __fadd_rn(acc, valid ? (inside ? m : default_prob) : 0.0f);
        }
        part[p * CG + cl] = acc;
    }
    __syncthreads();

    const float div = divisor[b];
    if (threadIdx.x < ncand) {
        float acc = 0.0f;
        for (int q = 0; q < P; ++q)
            acc = __fadd_rn(acc, part[q * CG + threadIdx.x]);
        const int c = cbeg + threadIdx.x;
        scores[(static_cast<size_t>(ba) * N + c % N) * N + c / N] = __fdiv_rn(acc, div);
    }
}

}  // namespace

// `geometry` holds B, A, S, N, H, W, L, P, G, CG and the shared bytes, in
// that order, as the caller computed them (one pointer instead of eleven
// integers: the call is cheaper to make from Python). CG * P may not exceed
// kBlockThreads; the map must hold at least one cell. Returns
// cudaGetLastError().
extern "C" int correlation_scores_launch(
    const float* probs, const float* rx, const float* ry,
    const unsigned char* svalid, const float* xs, const float* ys,
    const float* divisor, float* scores,
    const int* geometry, float default_prob, void* stream)
{
    const int* g = geometry;
    const int B = g[0], A = g[1], S = g[2], N = g[3], H = g[4], W = g[5];
    const int L = g[6], P = g[7], G = g[8], CG = g[9], shared_bytes = g[10];
    static int opted_in = 48 * 1024;
    if (shared_bytes > opted_in) {
        cudaError_t err = cudaFuncSetAttribute(
            correlation_scores_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in = shared_bytes;
    }
    correlation_scores_kernel<<<B * A * G, CG * P, shared_bytes,
                                static_cast<cudaStream_t>(stream)>>>(
        probs, rx, ry, svalid, xs, ys, divisor, scores,
        A, S, N, H, W, L, P, G, CG, default_prob);
    return static_cast<int>(cudaGetLastError());
}
